"""repro_torch's audio family (whisper-large-v3: a bidirectional encoder over
frame embeddings, a decoder of self-attention, cross-attention and a gelu
MLP, LayerNorm, attention and MLP biases, sinusoidal positions and no
RoPE, an untied head) against repro on the CPU.

The reduced model (2 encoder and 2 decoder layers, 16 frames), its weights
crossing as a ``save_tree`` .npz file with every bias and norm parameter
drawn away from its init from a seed, and random frames in every batch:
``sinusoidal_positions``, the cross-attention layer with its q, v and o
biases, the one-token cross route at G = 1, the ``enc`` and ``dec``
blocks, the encoder, logits (also through the Pallas interpreter), split
serving in bf16/w8/w4 (the encoder runs in the head and again in the
tail), caches and decode, greedy decode, the scheduler (with the
reference's zero frames), the plan and parameter counts, export,
quantization, the execute backend, the serve CLI and the degeneracy
guard."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import forward_logits as jax_forward_logits  # noqa: E402
from repro.models.attention import apply_cross_attn  # noqa: E402
from repro.models.attention_core import plain_attention as jax_plain_attention  # noqa: E402
from repro.models.blocks import apply_block  # noqa: E402
from repro.models.layers import sinusoidal_positions as jax_sinusoidal_positions  # noqa: E402
from repro.models.model import _encode as jax_encode  # noqa: E402

import torch_cross_common as C  # noqa: E402
from torch_cross_common import one_thread  # noqa: E402,F401
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.partition import cut_points  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import enc_stack_defs, forward_logits, stack_defs  # noqa: E402
from repro_torch.models.attention import CrossAttention, SelfAttention  # noqa: E402
from repro_torch.models.blocks import Block, DecBlock  # noqa: E402
from repro_torch.models.layers import LayerNorm, sinusoidal_positions  # noqa: E402
from repro_torch.models.model import StackDef, Sub  # noqa: E402

ARCH = "whisper-large-v3"
F32_EPS = 2.0 ** -23


@pytest.fixture(scope="module")
def whisper(tmp_path_factory):
    return C.build(ARCH, tmp_path_factory.mktemp("npz"))


# n, d, offset: the reduced encoder and a decode step's position, the
# published encoder (1500 frames) and decoder (448 tokens), a decode step
# there, and d = 2 (half = 1, where the reference's max(half - 1, 1) bites)
@pytest.mark.parametrize("n,d,offset", [(16, 256, 0), (1, 256, 23), (1500, 1280, 0),
                                        (448, 1280, 0), (4, 1280, 444), (3, 2, 5)])
def test_sinusoidal_positions_match_reference(n, d, offset):
    """The same f32 formula: the two differ by at most one ulp of a
    frequency (XLA's exp against torch's) times the position, plus the
    sin and cos rounding."""
    want = np.asarray(jax_sinusoidal_positions(n, d, offset=offset))
    got = sinusoidal_positions(n, d, offset=offset)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, d) == want.shape
    pos = np.arange(n, dtype=np.float64)[:, None] + offset
    assert (np.abs(got.numpy() - want) <= 2e-6 + 2 * F32_EPS * pos).all()
    half = d // 2
    exact = pos * np.exp(-np.log(1e4) * np.arange(half) / max(half - 1, 1))[None]
    np.testing.assert_allclose(got.numpy(), np.concatenate([np.sin(exact), np.cos(exact)], 1),
                               rtol=0, atol=2e-6 + 4 * F32_EPS * (n + offset))


def test_stacks_hold_the_decoder_and_the_encoder(whisper):
    f = whisper
    assert stack_defs(f.cfg) == (StackDef("main", 2, (Sub("blk", "dec"),)),)
    assert enc_stack_defs(f.cfg) == (StackDef("enc", 2, (Sub("blk", "enc"),)),)
    assert isinstance(f.model.stacks["main"][0].blk, DecBlock)
    enc = f.model.enc_stacks["enc"][1].blk
    assert isinstance(enc, Block) and isinstance(enc.attn, SelfAttention) and not enc.attn.causal
    assert isinstance(f.model.enc_norm, LayerNorm) and f.model.lm_head is not None
    assert f.model.stacks["main"][0].blk.attn.rope_theta is None
    assert cut_points(f.cfg) == [("main", 1), ("main", 2)]


# --------------------------------------------------------------------------
# the cross-attention layer, the one-token route, the blocks, the encoder
# --------------------------------------------------------------------------

def _dec_params(f, step=0):
    p = jax.tree.map(lambda a: a[step], f.params["stacks"]["main"]["blk"])
    return p, f.model.stacks["main"][step].blk


CROSS_CASES = [(24, "kv_src", "train"), (16, "kv_src", "train"), (24, "cache", "train"),
               (1, "kv_src", "prefill"), (1, "cache", "decode")]


@pytest.mark.parametrize("S,source,mode", CROSS_CASES)
def test_cross_attention_matches_reference(whisper, S, source, mode):
    """Against ``apply_cross_attn`` within 2e-5 with its q, v and o biases
    (k has none): Sq != Skv, Sq == Skv (16 tokens over 16 frames), from a
    cache, and a one-token decode step through the port's decode route."""
    f = whisper
    p, block = _dec_params(f, 1)
    layer = block.xattn
    assert isinstance(layer, CrossAttention) and layer.bq is not None and layer.bv is not None
    r = np.random.default_rng(S)
    x = r.normal(size=(2, S, f.cfg.d_model)).astype(np.float32)
    enc = r.normal(size=(2, f.cfg.encoder_seq, f.cfg.d_model)).astype(np.float32)
    _, jcache = apply_cross_attn(f.jcfg, p["xattn"], jnp.asarray(x), kv_src=jnp.asarray(enc))
    _, cache = layer(torch.from_numpy(x), kv_src=torch.from_numpy(enc))
    for key in ("xk", "xv"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]), **C.TOL)
    if source == "kv_src":
        want, _ = apply_cross_attn(f.jcfg, p["xattn"], jnp.asarray(x), kv_src=jnp.asarray(enc))
        got, _ = layer(torch.from_numpy(x), kv_src=torch.from_numpy(enc), mode=mode)
    else:
        want, _ = apply_cross_attn(f.jcfg, p["xattn"], jnp.asarray(x), cache=jcache)
        got, new = layer(torch.from_numpy(x), cache=cache, mode=mode)
        assert new is cache
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **C.TOL)


@pytest.mark.parametrize("B,H,Skv", [(4, 20, 1500), (1, 4, 16), (3, 2, 7)])
def test_one_token_cross_route_at_one_query_head_a_kv_head(B, H, Skv):
    """Whisper's G = 1 (multi-head): the decode route's plain version over
    the cache as a full ring against the reference's unmasked attention."""
    r = np.random.default_rng(B + Skv)
    q = r.normal(size=(B, 1, H, 64)).astype(np.float32)
    k, v = (r.normal(size=(B, Skv, H, 64)).astype(np.float32) for _ in range(2))
    want = jax_plain_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               q_positions=jnp.zeros((1,), jnp.int32),
                               kv_positions=jnp.zeros((Skv,), jnp.int32), causal=False,
                               window=None)
    got = ops.decode_attention(torch.from_numpy(q)[:, 0], torch.from_numpy(k).transpose(1, 2),
                               torch.from_numpy(v).transpose(1, 2), Skv - 1)[:, None]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **C.TOL)


def test_enc_block_matches_reference(whisper):
    """The bidirectional block: a later key changes an earlier output."""
    f = whisper
    p = jax.tree.map(lambda a: a[1], f.params["enc_stacks"]["enc"]["blk"])
    block = f.model.enc_stacks["enc"][1].blk
    x = np.random.default_rng(4).normal(size=(2, 16, f.cfg.d_model)).astype(np.float32)
    want, _, _ = apply_block(f.jcfg, "enc", p, jnp.asarray(x), mode="train", pos0=0)
    got, cache = block(torch.from_numpy(x))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **C.TOL)
    x2 = x.copy()
    x2[:, -1] = np.random.default_rng(5).normal(size=x2[:, -1].shape)
    moved, _ = block(torch.from_numpy(x2))
    assert (moved[:, 0] - got[:, 0]).abs().max() > 1e-3


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_dec_block_matches_reference(whisper, mode):
    """Causal self-attention, cross-attention and the MLP against
    ``apply_block(..., "dec", ...)`` within 2e-5: a 24-token prompt into
    28-slot rings, then one token at position 24; the cache is one dict of
    k, v, xk, xv."""
    f = whisper
    p, block = _dec_params(f)
    r = np.random.default_rng(5)
    x = r.normal(size=(2, 24, f.cfg.d_model)).astype(np.float32)
    enc = r.normal(size=(2, f.cfg.encoder_seq, f.cfg.d_model)).astype(np.float32)
    pre = "train" if mode == "train" else "prefill"
    want, jcache, _ = apply_block(f.jcfg, "dec", p, jnp.asarray(x), mode=pre, pos0=0,
                                  kv_src=jnp.asarray(enc), cache_len=28)
    got, cache = block(torch.from_numpy(x), mode=pre, kv_src=torch.from_numpy(enc),
                       cache_len=28 if pre == "prefill" else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **C.TOL)
    if mode == "train":
        assert cache is None and jcache is None
        return
    assert sorted(cache) == sorted(jcache) == ["k", "v", "xk", "xv"]
    for key in cache:
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]), **C.TOL)
    if mode == "prefill":
        return
    x1 = r.normal(size=(2, 1, f.cfg.d_model)).astype(np.float32)
    want, jnew, _ = apply_block(f.jcfg, "dec", p, jnp.asarray(x1), mode="decode", pos0=24,
                                cache=jcache)
    got, new = block(torch.from_numpy(x1), pos0=24, mode="decode", cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **C.TOL)
    for key in new:
        np.testing.assert_allclose(new[key].numpy(), np.asarray(jnew[key]), **C.TOL)
    assert new["k"].data_ptr() == cache["k"].data_ptr()      # the ring written in place


def test_encoder_matches_reference(whisper):
    """Frames plus positions, the enc stack in train mode, enc_norm."""
    f = whisper
    frames = C.inputs(f.cfg, 2, 4, 9)["enc_frames"]
    want = jax_encode(f.jcfg, f.params, jnp.asarray(frames))
    got = f.model.encode(torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **C.TOL)
    assert f.model.kv_src({"enc_frames": torch.from_numpy(frames)}).shape == got.shape


# --------------------------------------------------------------------------
# the model: logits, split serving, caches and decode, serving
# --------------------------------------------------------------------------

def test_forward_logits_match_reference(whisper):
    C.check_logits_and_splits(whisper, 6)


def test_forward_logits_match_reference_through_pallas_interpret(whisper, monkeypatch):
    """The reference's encoder and decoder self-attention reach its Pallas
    kernel (16 frames and 24 tokens, multiples of 8; the 24-over-16 cross
    attention stays plain)."""
    f = whisper
    batch = C.inputs(f.cfg, 2, C.PROMPT, 12)
    monkeypatch.setenv("REPRO_USE_PALLAS", "interpret")
    want = jax_forward_logits(f.jcfg, f.params, C.jx(batch))
    monkeypatch.delenv("REPRO_USE_PALLAS")
    got = forward_logits(f.cfg, f.model, C.th(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **C.MODEL_TOL)


@pytest.mark.parametrize("version", ["bf16", "w8", "w4"])
def test_split_serving_matches_reference_engine(whisper, version):
    C.check_split_serving(whisper, version, 7)


def test_split_runs_the_encoder_in_the_head_and_in_the_tail(whisper):
    """As the reference's partition does: both sides compute kv_src from
    the batch's frames, at every cut."""
    from repro_torch.core.partition import run_head, run_tail
    f = whisper
    batch = C.th(C.inputs(f.cfg, 1, 8, 13))
    calls = []
    hook = f.model.enc_norm.register_forward_hook(lambda *a: calls.append(1))
    try:
        for cut in cut_points(f.cfg):
            run_tail(f.cfg, f.model, run_head(f.cfg, f.model, batch, cut), batch, cut)
    finally:
        hook.remove()
    assert len(calls) == 2 * len(cut_points(f.cfg))


def test_prefill_cache_and_decode_steps_match_reference(whisper):
    C.check_prefill_and_decode(whisper, 8)


def test_cache_tree_and_axes_equal_reference(whisper):
    f = whisper
    C.check_cache_trees(f.cfg, f.jcfg)
    assert C.cache_axes(f.cfg)["main"]["blk"] == {
        "k": ("layers", "batch", "kv_cache_seq", "kv_heads", None),
        "v": ("layers", "batch", "kv_cache_seq", "kv_heads", None),
        "xk": ("layers", "batch", None, "kv_heads", None),
        "xv": ("layers", "batch", None, "kv_heads", None)}


def test_serving_engine_greedy_tokens_equal_reference(whisper):
    C.check_greedy(whisper, 10)


def test_continuous_batching_equals_reference(whisper):
    C.check_scheduler(whisper, 11)


# --------------------------------------------------------------------------
# weights: the plan, export, quantization
# --------------------------------------------------------------------------

def test_plan_matches_reference_leaf_by_leaf(whisper):
    f = whisper
    C.check_plan(f.cfg, f.jcfg)
    plan = C.plan_model(f.cfg)
    assert sorted(k.rsplit("/", 1)[1] for k in plan if k.startswith("stacks/main/blk/xattn/")) \
        == ["bo", "bq", "bv", "wk", "wo", "wq", "wv"]
    assert "enc_norm/bias" in plan and "lm_head" in plan
    assert plan["enc_stacks/enc/blk/mlp/b_up"].shape == (2, f.cfg.d_ff)


@pytest.mark.parametrize("enc,dec,want", [(32, 32, 1_601_812_480), (2, 2, 224_596_480)])
def test_full_plan_counts_the_parameters(enc, dec, want):
    """From the plan alone: the published 32 + 32 layers that chip_smoke.py
    serves whole on one card, and the 2 + 2 it compares with the CPU."""
    assert C.full_param_count(ARCH, n_encoder_layers=enc, n_layers=dec) == want


def test_export_roundtrips_reference_params(whisper):
    C.check_export(whisper)


@pytest.mark.parametrize("version", ["w8", "w4"])
def test_quantize_tree_quantizes_the_references_leaves(whisper, version):
    """The encoder's and the decoder's self-attention, cross-attention and
    MLP projections, and the untied head; biases and norms stay the float
    model's tensors."""
    got, want = C.quantized_leaves(whisper, version)
    assert {C.port_name(n) for n in got} == want
    assert len(want) == 6 + 10 + 1     # stacked leaves: enc (4 + 2), dec (4 + 4 + 2), head


# --------------------------------------------------------------------------
# the controller's execute backend, the CLI, the degeneracy guard
# --------------------------------------------------------------------------

def test_execute_over_audio_matches_reference():
    C.check_execute(ARCH)


def test_serve_cli_runs_whisper_on_the_cpu():
    C.check_serve_cli(ARCH)


def test_config_matches_reference():
    import dataclasses
    from repro.configs import get_config as jax_get_config
    for ref, port in ((jax_get_config(ARCH), get_config(ARCH)),
                      (jax_get_config(ARCH).reduced(), get_config(ARCH).reduced())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert not get_config(ARCH).tie_embeddings      # an untied head, as the reference's


def test_degeneracy_guard_the_cross_path_moves_the_logits(whisper):
    """With every cross-attention's wo and bo set to zero the decoder no
    longer reads the frames; on each side the logits then move by more
    than 100x the parity tolerance."""
    f = whisper
    batch = C.inputs(f.cfg, 2, C.PROMPT, 6)
    base = forward_logits(f.cfg, f.model, C.th(batch))
    jbase = np.asarray(jax_forward_logits(f.jcfg, f.params, C.jx(batch)))
    layers = [m for m in f.model.modules() if isinstance(m, CrossAttention)]
    saved = [(m.wo.weight.data.clone(), m.bo.data.clone()) for m in layers]
    try:
        for m in layers:
            m.wo.weight.data.zero_()
            m.bo.data.zero_()
        cut = forward_logits(f.cfg, f.model, C.th(batch))
    finally:
        for m, (w, b) in zip(layers, saved):
            m.wo.weight.data.copy_(w)
            m.bo.data.copy_(b)

    def zero(path, a):
        keys = [str(k.key) for k in path]
        return jnp.zeros_like(a) if "xattn" in keys and keys[-1] in ("wo", "bo") else a
    jcut = np.asarray(jax_forward_logits(f.jcfg, jax.tree_util.tree_map_with_path(
        zero, f.params), C.jx(batch)))
    limit = C.GUARD * C.MODEL_TOL["atol"]
    assert (base - cut).abs().max().item() > limit
    assert np.abs(jbase - jcut).max() > limit
    np.testing.assert_allclose(cut.numpy(), jcut, **C.MODEL_TOL)
