"""whisper-large-v3 [audio] — encoder-decoder, conv frontend STUB.

32 encoder + 32 decoder layers, d_model 1280, 20 heads (MHA, kv=20),
gelu MLP, layernorm, attention biases, sinusoidal positions (no RoPE).
The mel-spectrogram + conv feature extractor is a STUB: ``input_specs``
supplies 1500 precomputed frame embeddings. [arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-large-v3",
    family="audio",
    source="arXiv:2212.04356 (Whisper) / hf:openai/whisper-large-v3",
    n_layers=32,             # decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51_866,
    head_dim=64,
    enc_dec=True,
    n_encoder_layers=32,
    encoder_seq=1500,
    use_rope=False,
    attn_bias=True,
    norm="layernorm",
    mlp_act="gelu",
))
