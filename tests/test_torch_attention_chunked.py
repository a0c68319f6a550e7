"""repro_torch's chunked CPU attention against repro's: ``chunked_attention``
and ``chunked_attention_causal_skip`` on the same numpy inputs within 2e-5
in f32 (GQA 4/2, causal and windowed masks, ragged last chunks, Sq != Skv
without a mask, positions past 0); ``attention``'s dispatch taking each
branch where the reference's takes it (``chunked_threshold`` passed low to
reach the chunked branch at small sizes, as tests/test_properties.py calls
the reference's chunked attention at small chunks); the model's
self-attention and MLA passing the config's chunk fields as the
reference's do; and the matmul FLOPs of a reduced qwen2 prefill and train
step past the threshold, baseline and ``attn_causal_skip``, equal to the
reference's ``dot_general`` FLOPs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.analysis.jaxpr_cost import analyze_jaxpr_by_op  # noqa: E402
from repro.checkpointing import save_tree as jax_save_tree  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import attention_core as ref_ac  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import init as ref_init  # noqa: E402
from repro.models import forward_train as ref_forward_train  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402

from repro_torch.analysis.op_cost import analyze_fn_by_op, matmul_flops  # noqa: E402
from repro_torch.checkpointing import load_tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps as st  # noqa: E402
from repro_torch.models import attention_core as ac  # noqa: E402
from repro_torch.models import forward_train, init, load_jax_params, param_tree  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.delenv("REPRO_USE_PALLAS", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(B, Sq, Skv, H, HK, D, Dv, seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, Sq, H, D)).astype(np.float32),
            r.normal(size=(B, Skv, HK, D)).astype(np.float32),
            r.normal(size=(B, Skv, HK, Dv)).astype(np.float32))


def _both(ref_fn, fn, arrays, qp, kp, **kw):
    want = ref_fn(*(jnp.asarray(a) for a in arrays), q_positions=jnp.asarray(qp),
                  kv_positions=jnp.asarray(kp), **kw)
    got = fn(*(torch.from_numpy(a) for a in arrays), q_positions=torch.from_numpy(qp).long(),
             kv_positions=torch.from_numpy(kp).long(), **kw)
    return np.asarray(want), got


# (B, Sq, Skv, H, HK, D, Dv, causal, window, q_chunk, kv_chunk, offset)
CHUNKED = [
    (2, 64, 64, 4, 2, 16, 16, True, None, 16, 32, 0),      # GQA 4/2, whole chunks
    (1, 50, 50, 4, 2, 16, 16, True, None, 16, 32, 0),      # ragged last q and kv chunks
    (2, 48, 48, 4, 2, 8, 8, True, 12, 16, 16, 5),          # windowed, positions past 0
    (1, 37, 53, 4, 2, 16, 16, False, None, 8, 16, 0),      # Sq != Skv, no mask
    (1, 40, 40, 4, 4, 24, 16, True, None, 16, 16, 0),      # D != Dv (MLA's shape)
    (1, 20, 20, 4, 1, 16, 16, True, None, 64, 64, 0),      # chunks past the sequence
]


@pytest.mark.parametrize("B,Sq,Skv,H,HK,D,Dv,causal,window,qc,kc,off", CHUNKED)
def test_chunked_attention_equals_the_reference(B, Sq, Skv, H, HK, D, Dv, causal, window,
                                                qc, kc, off):
    arrays = _qkv(B, Sq, Skv, H, HK, D, Dv, Sq * 7 + Skv)
    qp = np.arange(Sq, dtype=np.int32) + off + (Skv - Sq if causal else 0)
    kp = np.arange(Skv, dtype=np.int32) + off
    want, got = _both(ref_ac.chunked_attention, ac.chunked_attention, arrays, qp, kp,
                      causal=causal, window=window, q_chunk=qc, kv_chunk=kc,
                      logit_scale=0.3 if D != Dv else None)
    assert got.dtype == torch.float32 and got.shape == (B, Sq, H, Dv)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # and the plain masked attention, both packages' oracle
    plain = ac.plain_attention(*(torch.from_numpy(a) for a in arrays),
                               q_positions=torch.from_numpy(qp).long(),
                               kv_positions=torch.from_numpy(kp).long(), causal=causal,
                               window=window, logit_scale=0.3 if D != Dv else None)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("S,window,qc,kc", [(64, None, 16, 32), (50, None, 16, 16),
                                            (48, 10, 8, 16), (33, None, 32, 64)])
def test_causal_skip_equals_the_reference(S, window, qc, kc):
    arrays = _qkv(2, S, S, 4, 2, 16, 16, S)
    pos = np.arange(S, dtype=np.int32)
    want, got = _both(ref_ac.chunked_attention_causal_skip, ac.chunked_attention_causal_skip,
                      arrays, pos, pos, window=window, q_chunk=qc, kv_chunk=kc)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_causal_skip_needs_self_attention():
    q, k, v = (torch.zeros(1, n, 2, 8) for n in (8, 12, 12))
    with pytest.raises(ValueError, match="self-attention"):
        ac.chunked_attention_causal_skip(q, k, v, q_positions=torch.arange(8),
                                         kv_positions=torch.arange(12), q_chunk=4)


def test_chunked_attention_gradients_match_the_plain_ones():
    """The CPU train path differentiates the chunk loop: its gradients equal
    the plain attention's within 2e-5."""
    arrays = _qkv(1, 40, 40, 4, 2, 16, 16, 11)
    pos = torch.arange(40)
    grads = []
    for fn, kw in ((ac.chunked_attention, dict(q_chunk=16, kv_chunk=16)),
                   (ac.chunked_attention_causal_skip, dict(q_chunk=16, kv_chunk=16)),
                   (ac.plain_attention, {})):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
        out = fn(q, k, v, q_positions=pos, kv_positions=pos, window=9, **kw)
        (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
        grads.append([t.grad for t in (q, k, v)])
    for g in grads[:2]:
        for a, b in zip(g, grads[2]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


# --------------------------------------------------------------------------
# the dispatch
# --------------------------------------------------------------------------

BRANCHES = ("chunked_attention_causal_skip", "chunked_attention", "plain_attention")


def _spy(monkeypatch, module, names):
    """Record which of ``names`` the dispatch calls first (the causal-skip
    branch calls chunked_attention in turn)."""
    taken = []
    for name in names:
        fn = getattr(module, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            taken.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(module, name, wrapped)
    return taken


# (Sq, Skv, causal, window, threshold, q_chunk, kv_chunk, causal_skip, branch)
DISPATCH = [
    (48, 48, True, None, 2048, 16, 32, True, "chunked_attention_causal_skip"),
    (48, 48, True, 8, 16, 16, 32, True, "chunked_attention_causal_skip"),
    (16, 16, True, None, 8, 16, 32, True, "chunked_attention"),       # Sq == q_chunk
    (48, 48, False, None, 16, 16, 32, True, "chunked_attention"),     # skip needs causal
    (48, 48, True, None, 47, 16, 32, False, "chunked_attention"),
    (48, 48, True, None, 48, 16, 32, False, "plain_attention"),       # at the threshold
    (24, 40, False, None, 16, 8, 16, True, "chunked_attention"),      # Sq != Skv
    (24, 40, False, None, 2048, 8, 16, True, "plain_attention"),
]


@pytest.mark.parametrize("Sq,Skv,causal,window,thr,qc,kc,skip,branch", DISPATCH)
def test_attention_takes_the_references_branch(monkeypatch, Sq, Skv, causal, window, thr, qc,
                                               kc, skip, branch):
    arrays = _qkv(2, Sq, Skv, 4, 2, 16, 16, Sq + thr)
    qp = np.arange(Sq, dtype=np.int32) + (Skv - Sq)
    kp = np.arange(Skv, dtype=np.int32)
    ref_taken = _spy(monkeypatch, ref_ac, BRANCHES)
    taken = _spy(monkeypatch, ac, BRANCHES)
    kw = dict(causal=causal, window=window, chunked_threshold=thr, q_chunk=qc, kv_chunk=kc,
              causal_skip=skip)
    want, got = _both(ref_ac.attention, ac.attention, arrays, qp, kp, **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # below the threshold the port's self-attention goes through the flash
    # kernel's plain version, which is plain_attention on (B, S, H, D)
    assert ref_taken[:1] == taken[:1] == [branch]


# --------------------------------------------------------------------------
# the config's chunk fields reach the attention calls
# --------------------------------------------------------------------------

def _record_calls(monkeypatch, module):
    calls = []
    fn = module.attention

    def wrapped(*a, **kw):
        calls.append({k: kw.get(k) for k in ("q_chunk", "kv_chunk", "causal_skip",
                                             "chunked_threshold")})
        return fn(*a, **kw)
    monkeypatch.setattr(module, "attention", wrapped)
    return calls


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v2-lite-16b", "whisper-large-v3"])
def test_models_pass_the_chunk_fields_as_the_reference(monkeypatch, tmp_path, arch):
    """One forward of the reduced arch with its chunk fields set: the
    attention calls receive what the reference's receive (self-attention
    the three fields, MLA the two chunks, cross-attention none), and the
    loss agrees within 5e-4."""
    over = dict(attn_q_chunk=16, attn_kv_chunk=32, attn_causal_skip=True)
    jcfg = ref_get_config(arch).reduced().with_overrides(**over)
    cfg = get_config(arch).reduced().with_overrides(**over)
    params = ref_init(jcfg, jax.random.key(0))
    path = str(tmp_path / "params.npz")
    jax_save_tree(path, params)
    model = load_jax_params(cfg, load_tree(path)[0], device="cpu")
    r = np.random.default_rng(0)
    tokens = r.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, 1)}
    if cfg.enc_dec:
        batch["enc_frames"] = r.normal(size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    ref_calls = _record_calls(monkeypatch, ref_ac)
    calls = _record_calls(monkeypatch, ac)
    want, _ = ref_forward_train(jcfg, params, {k: jnp.asarray(v) for k, v in batch.items()},
                                remat=False)
    got, _ = forward_train(cfg, model, {k: torch.from_numpy(v).long() if v.dtype == np.int32
                                        else torch.from_numpy(v) for k, v in batch.items()},
                           remat=False)
    # the reference traces its scanned layers once, the port calls each
    # layer: the same kinds of call
    assert calls and set(map(repr, calls)) == set(map(repr, ref_calls))
    np.testing.assert_allclose(float(got), float(want), **MODEL_TOL)


# --------------------------------------------------------------------------
# matmul FLOPs past the threshold
# --------------------------------------------------------------------------

B, S_LONG = 1, 2304     # 2304^2 > 2048^2: the chunked branch


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("skip", [False, True], ids=["baseline", "causal_skip"])
def test_matmul_flops_past_the_threshold_equal_the_references(kind, skip):
    """Reduced qwen2-0.5b over 2304 tokens, with and without
    ``attn_causal_skip``: the chunk loop's products are the reference's
    scan bodies times their trip counts."""
    over = dict(attn_causal_skip=skip)
    jcfg = ref_get_config("qwen2-0.5b").reduced().with_overrides(**over)
    cfg = get_config("qwen2-0.5b").reduced().with_overrides(**over)
    params = ref_model.abstract_params(jcfg)
    model = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                               (B, S_LONG)))
    if kind == "prefill":
        ref = jax.make_jaxpr(ref_steps.make_prefill_step(jcfg))(
            params, ref_steps.prefill_batch_specs(jcfg, B, S_LONG))
        fn, args = st.make_prefill_step(cfg), (model, {"tokens": tokens})
    else:
        ref = jax.make_jaxpr(ref_steps.make_train_step(jcfg, RefAdamWConfig(), remat=True))(
            params, jax.eval_shape(ref_adamw_init, params),
            ref_steps.batch_specs(jcfg, B, S_LONG))
        fn = st.make_train_step(cfg, AdamWConfig(), remat=True)
        args = (model, adamw_init(param_tree(model)),
                {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)})
    want = analyze_jaxpr_by_op(ref)["dot_general"]["flops"]
    got = matmul_flops(analyze_fn_by_op(fn, *args))
    assert got == want > 0
