"""repro_torch's training path against repro on the CPU: the plain backward
of flash attention, the synthetic data pipeline, ``forward_train`` for all
ten reduced archs, the gradients leaf by leaf, remat, the train step with
and without microbatches, learning, checkpoints across the two packages,
the two training CLIs, and the card's refusal of configs whose train path
reaches a kernel without a backward.

Weights cross as a ``save_tree`` .npz file with gates, biases and norm
parameters drawn away from the init's zeros and ones, so that their
gradients and the cross-attention paths count; inputs are made with numpy
from a seed and handed to both packages."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpointing import latest_step as jax_latest_step  # noqa: E402
from repro.checkpointing import load_tree as jax_load_tree  # noqa: E402
from repro.checkpointing import restore_checkpoint as jax_restore_checkpoint  # noqa: E402
from repro.checkpointing import save_checkpoint as jax_save_checkpoint  # noqa: E402
from repro.checkpointing import save_tree as jax_save_tree  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro.kernels.ref import flash_attention_ref as jax_flash_attention_ref  # noqa: E402
from repro.launch.steps import config_for_shape as jax_config_for_shape  # noqa: E402
from repro.launch.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import forward_train as jax_forward_train  # noqa: E402
from repro.models import init as jax_init  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402

from repro_torch.checkpointing import (latest_step, load_tree, restore_checkpoint,  # noqa: E402
                                       save_checkpoint, save_tree)
from repro_torch.configs import ALL_ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.data import (DataConfig, SyntheticLMDataset, make_train_iterator,  # noqa: E402
                              to_device)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch import train_lm  # noqa: E402
from repro_torch.launch.steps import (check_trainable_on_card, config_for_shape,  # noqa: E402
                                      kernels_without_backward, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.models import (assign_params, export_grads, export_params,  # noqa: E402
                                forward_logits, forward_train, init, load_jax_params,
                                param_tree, set_trainable)
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=5e-4, atol=5e-4)
# jax.grad of the reference's loss against the port's autograd, leaf by
# leaf: f32 sums in other orders through two layers and a 2 x 24-token
# cross-entropy; a gradient of ~1e-2 keeps ~5 digits
GRAD_TOL = dict(rtol=1e-3, atol=2e-6)
NONZERO = ("scale", "bias", "bq", "bk", "bv", "bo", "b_up", "b_down", "gate_attn",
           "gate_mlp", "q_norm", "k_norm", "kv_norm")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the port's ops here are small, and one thread
    does not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# the plain backward of flash attention against jax.vjp of the reference's
# --------------------------------------------------------------------------

# (B, H, HK, Sq, Skv, D, Dv, causal, window): causal; windowed; unmasked at
# Sq != Skv; D != Dv; a GQA case where h % HK and h // G differ (every case
# with HK > 1 and G > 1 is one); then deepseek-v2-lite's MLA widths, (192,
# 128) and the reduced (48, 32), GQA 16/4 and MHA 16/16, ragged and whole
# 64-row tiles, causal and unmasked at Sq != Skv
BWD_CASES = [(2, 4, 2, 24, 24, 16, 16, True, None), (1, 6, 2, 40, 40, 16, 16, True, 8),
             (2, 4, 4, 12, 30, 16, 16, False, None), (1, 4, 2, 20, 20, 24, 8, True, None),
             (2, 6, 3, 17, 17, 8, 8, False, 5), (1, 6, 2, 9, 33, 16, 12, False, None),
             (1, 16, 4, 40, 40, 192, 128, True, None), (1, 16, 16, 100, 100, 192, 128, True, None),
             (1, 16, 4, 128, 128, 192, 128, True, None), (1, 16, 16, 64, 64, 192, 128, True, None),
             (1, 16, 16, 40, 100, 192, 128, False, None),
             (1, 16, 4, 40, 100, 192, 128, False, None), (1, 16, 4, 100, 100, 48, 32, True, None),
             (1, 16, 16, 128, 128, 48, 32, True, None), (1, 16, 4, 40, 100, 48, 32, False, None),
             (1, 16, 16, 40, 40, 48, 32, True, None)]


def _bwd_inputs(B, H, HK, Sq, Skv, D, Dv, seed):
    r = np.random.default_rng(seed)
    return [r.normal(size=s).astype(np.float32)
            for s in ((B, H, Sq, D), (B, HK, Skv, D), (B, HK, Skv, Dv), (B, H, Sq, Dv))]


@pytest.mark.parametrize("case", BWD_CASES)
def test_plain_backward_matches_jax_vjp(case):
    """``flash_attention_bwd_ref`` (lse, delta, dS, GQA by h % HK) against
    ``jax.vjp`` of ``repro.kernels.ref.flash_attention_ref`` within 2e-5 in
    f32; the plain forward's lse against the log-sum-exp of the reference's
    masked scores."""
    B, H, HK, Sq, Skv, D, Dv, causal, window = case
    q, k, v, do = _bwd_inputs(B, H, HK, Sq, Skv, D, Dv, seed=sum(case[:7]))
    fn = lambda q_, k_, v_: jax_flash_attention_ref(q_, k_, v_, causal=causal, window=window)  # noqa: E731
    want_o, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash_attention_ref(tq, tk, tv, causal=causal, window=window, with_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    # the reference's scores, masked with its -1e30, by h % HK
    s = np.einsum("bhqd,bhkd->bhqk", q, np.tile(k, (1, H // HK, 1, 1))) * D ** -0.5
    i, j = np.arange(Sq)[:, None], np.arange(Skv)[None]
    vis = np.ones((Sq, Skv), bool)
    if causal:
        vis &= j <= i
    if window is not None:
        vis &= i - j < window
    s = np.where(vis, s, -1e30)
    want_lse = s.max(-1) + np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)
    got = flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


def test_plain_backward_equals_autograd_and_reads_kv_head_h_mod_hk():
    """The explicit backward against autograd through the plain forward;
    and the grouping: with kv heads read as h // G (repeat_interleave) the
    gradient moves."""
    B, H, HK, S, D = 1, 6, 2, 16, 8
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(B, H, HK, S, S, D, D, 7))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o, lse = flash_attention_ref(q, k, v, causal=True, with_lse=True)
    auto = torch.autograd.grad(o, (q, k, v), do)
    got = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(),
                                  lse.detach(), do, causal=True)
    for a, b in zip(auto, got):
        torch.testing.assert_close(a, b, **TOL)
    G = H // HK
    kd, vd = (t.detach().repeat_interleave(G, 1) for t in (k, v))
    o2 = flash_attention_ref(q.detach(), kd, vd, causal=True)
    assert (o2 - o.detach()).abs().max() > 0.1


def test_plain_backward_in_f64_is_the_f32_versions_oracle():
    """f64 inputs run the plain backward in f64: the f32 result sits within
    f32 rounding of it."""
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(2, 4, 2, 20, 20, 16, 16, 9))
    o, lse = flash_attention_ref(q, k, v, causal=True, with_lse=True)
    g32 = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    g64 = flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o, lse, do)), causal=True)
    for a, b in zip(g32, g64):
        assert b.dtype == torch.float64
        torch.testing.assert_close(a.double(), b, rtol=1e-5, atol=1e-6)


def test_autograd_dispatch_keeps_the_plain_path_on_the_cpu():
    """On the CPU ``attention_bhsd`` differentiates the plain version and
    launches nothing; the kernels' wrappers refuse CPU tensors."""
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(1, 4, 2, 8, 8, 64, 64, 3))
    q.requires_grad_()
    before = (fa.launches, fa.bwd_launches)
    out = ops.attention_bhsd(q, k, v, causal=True)
    out.backward(do)
    assert q.grad is not None and (fa.launches, fa.bwd_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q.detach(), k, v, with_lse=True)
    o, lse = flash_attention_ref(q.detach(), k, v, with_lse=True)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(q.detach(), k, v, o, lse, do)
    assert (fa.launches, fa.bwd_launches) == before


def test_backward_kernel_refuses_head_dims_it_has_no_instance_for():
    """(D, Dv) outside the backward's instances raises and names the
    ROADMAP item; the covered pairs, MLA's (192, 128) and (48, 32) among
    them, pass."""
    assert {(192, 128), (48, 32)} <= set(fa.BWD_HEAD_DIMS)
    for dims in ((256, 256), (64, 128)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md section 2"):
            fa.check_bwd_head_dims(*dims)
    for dims in fa.BWD_HEAD_DIMS:
        fa.check_bwd_head_dims(*dims)
    assert set(fa.BWD_HEAD_DIMS) <= set(fa.HEAD_DIMS)


def c_argtypes(source, name):
    """ctypes argtypes of C entry point ``name``, read from its source: long
    long* a pointer to c_longlong, any other pointer c_void_p, float
    c_float, int c_int."""
    import ctypes
    import re
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', source).group(1)
    want = []
    for p in params.split(","):
        p = p.replace(" *", "*")
        want.append(ctypes.POINTER(ctypes.c_longlong) if "long long*" in p else
                    ctypes.c_void_p if "*" in p else
                    ctypes.c_float if p.split()[0] == "float" else ctypes.c_int)
    return want


def test_ctypes_signature_of_the_backward_entry_point(monkeypatch):
    """The backward wrapper's argtypes follow the C entry point's
    parameters, read from its CUDA source."""
    import ctypes
    import types

    from repro_torch.kernels import _build
    source = (_build.SRC_DIR / "flash_attention_bwd.cu").read_text()
    want = c_argtypes(source, "flash_attention_bwd")
    lib = types.SimpleNamespace(flash_attention_bwd=types.SimpleNamespace())
    monkeypatch.setattr(_build, "library", lambda n: lib if n == "flash_attention_bwd" else None)
    fa._bwd_entry.cache_clear()
    try:
        entry = fa._bwd_entry()
    finally:
        fa._bwd_entry.cache_clear()
    assert entry.argtypes == want and entry.restype is ctypes.c_int
    assert "flash_attention_bwd" in _build.KERNELS


def test_ctypes_signature_of_the_backward_plan_entry_point(monkeypatch):
    """The argtypes by which ``bwd_plan`` asks the kernel for its split
    follow the C entry point's parameters, read from its CUDA source."""
    import ctypes
    import types

    from repro_torch.kernels import _build
    source = (_build.SRC_DIR / "flash_attention_bwd.cu").read_text()
    want = c_argtypes(source, "flash_attention_bwd_plan")
    assert want[-1] is ctypes.c_void_p   # int* out, written by the kernel's side
    lib = types.SimpleNamespace(flash_attention_bwd_plan=types.SimpleNamespace())
    monkeypatch.setattr(_build, "library", lambda n: lib if n == "flash_attention_bwd" else None)
    fa._plan_entry.cache_clear()
    try:
        entry = fa._plan_entry()
    finally:
        fa._plan_entry.cache_clear()
    assert entry.argtypes[:-1] == want[:-1] and entry.restype is ctypes.c_int
    assert entry.argtypes[-1] == ctypes.POINTER(ctypes.c_int)


# --------------------------------------------------------------------------
# the data pipeline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,seed", [("qwen2-0.5b", 0), ("qwen2-0.5b", 7),
                                       ("llama-3.2-vision-90b", 1), ("whisper-large-v3", 2)])
def test_synthetic_batches_equal_reference_bit_for_bit(arch, seed):
    """Tokens, targets and the vlm's media or whisper's frames, at several
    steps and seeds, equal the reference's (values and dtypes)."""
    jd = JaxDataset(jax_get_config(arch).reduced(), JaxDataConfig(batch_size=3, seq_len=33,
                                                                 seed=seed))
    td = SyntheticLMDataset(get_config(arch).reduced(), DataConfig(batch_size=3, seq_len=33,
                                                                   seed=seed))
    for step in (0, 1, 9):
        want, got = jd.batch(step), td.batch(step)
        assert want.keys() == got.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{key} step {step}")


def test_train_iterator_puts_batches_on_the_device():
    cfg = get_config("qwen2-0.5b").reduced()
    data = DataConfig(batch_size=2, seq_len=8, seed=3)
    it = make_train_iterator(cfg, data, device="cpu")
    ds = SyntheticLMDataset(cfg, data)
    for step in range(2):
        b = next(it)
        assert b["tokens"].dtype == torch.int32 and b["tokens"].device.type == "cpu"
        np.testing.assert_array_equal(b["targets"].numpy(), ds.batch(step)["targets"])
    assert to_device(ds.batch(0), "cpu")["tokens"].shape == (2, 8)


def test_shapes_and_long_context_window_equal_reference():
    assert SHAPES == JAX_SHAPES
    for arch in ALL_ARCHS:
        for shape in SHAPES:
            want = jax_config_for_shape(jax_get_config(arch), shape)
            got = config_for_shape(get_config(arch), shape)
            assert got.sliding_window == want.sliding_window, (arch, shape)


# --------------------------------------------------------------------------
# forward_train and the gradients
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Pair:
    cfg: object
    jcfg: object
    jparams: object
    model: object


def _pair(arch, tmp_path, seed=0, **overrides):
    """One reduced model in both packages from one .npz file, its gates,
    biases and norm leaves drawn nonzero (and away from 1) from ``seed``."""
    jcfg = jax_get_config(arch).reduced().with_overrides(**overrides)
    cfg = get_config(arch).reduced().with_overrides(**overrides)
    p0, p1 = tmp_path / f"{arch}-0.npz", tmp_path / f"{arch}-1.npz"
    params = jax_init(jcfg, jax.random.key(seed))
    jax_save_tree(str(p0), params)
    flat, _ = load_tree(str(p0))
    r = np.random.default_rng(seed + 11)
    for key in sorted(flat):
        if key.rsplit("/", 1)[-1] in NONZERO:
            base = 1.0 if key.endswith(("scale", "norm")) else 0.0
            flat[key] = (base + 0.2 * r.normal(size=flat[key].shape)).astype(flat[key].dtype)
    save_tree(str(p1), flat)
    jparams, _ = jax_load_tree(str(p1), params)
    return Pair(cfg, jcfg, jparams, load_jax_params(cfg, flat, device="cpu"))


def _batch(cfg, B, S, seed):
    return SyntheticLMDataset(cfg, DataConfig(batch_size=B, seq_len=S, seed=seed)).batch(0)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_train_matches_reference(arch, tmp_path):
    """Loss and aux against ``repro.models.forward_train`` (remat off)
    within 5e-4, every reduced arch; the MoE archs' aux is nonzero."""
    f = _pair(arch, tmp_path)
    b = _batch(f.cfg, 2, 16, seed=ALL_ARCHS.index(arch))
    want, wmet = jax_forward_train(f.jcfg, f.jparams, {k: jnp.asarray(v) for k, v in b.items()},
                                   remat=False)
    with torch.no_grad():
        got, met = forward_train(f.cfg, f.model, to_device(b, "cpu"), remat=False)
    np.testing.assert_allclose(float(got), float(want), **MODEL_TOL)
    np.testing.assert_allclose(float(met["lm_loss"]), float(wmet["lm_loss"]), **MODEL_TOL)
    np.testing.assert_allclose(float(met["aux_loss"]), float(wmet["aux_loss"]), **MODEL_TOL)
    assert (float(met["aux_loss"]) > 0) == bool(f.cfg.moe)
    assert got.shape == () and got.dtype == torch.float32


def test_lm_loss_masks_negative_targets_and_chunks(tmp_path):
    """Targets < 0 drop out of the mean; a sequence past LOSS_CHUNK gives
    the loss of the logits whole."""
    from repro_torch.models.model import LOSS_CHUNK, lm_loss
    f = _pair("qwen2-0.5b", tmp_path)
    b = to_device(_batch(f.cfg, 2, 2 * LOSS_CHUNK, seed=1), "cpu")
    with torch.no_grad():
        h, _, _ = f.model._trunk(f.model.embed(b["tokens"]), mode="train")
        whole = torch.nn.functional.cross_entropy(
            f.model.head(h).flatten(0, 1).float(), b["targets"].flatten().long())
        torch.testing.assert_close(lm_loss(f.cfg, f.model, h, b["targets"]), whole,
                                   rtol=1e-5, atol=1e-5)
        t = b["targets"].clone()
        t[:, ::2] = -1
        logits = f.model.head(h).float()
        keep = t >= 0
        want = torch.nn.functional.cross_entropy(logits[keep], t[keep].long())
        torch.testing.assert_close(lm_loss(f.cfg, f.model, h, t), want, rtol=1e-5, atol=1e-5)


def _jax_grads(f, b):
    fn = lambda p: jax_forward_train(f.jcfg, p, b, remat=False)[0]  # noqa: E731
    g = jax.grad(fn)(f.jparams)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]}


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-0.6b", "deepseek-v2-lite-16b"])
def test_gradients_match_jax_grad_leaf_by_leaf(arch, tmp_path):
    """Every gradient leaf (``export_grads``, stacked as the reference's)
    against ``jax.grad`` of the reference's loss within GRAD_TOL; qwen2 with
    its QKV biases, qwen3 at head_dim 128 with its q/k norms, deepseek with
    MLA at its reduced (48, 32) head dims, its dense layer and its routed
    and shared experts."""
    f = _pair(arch, tmp_path, **({"head_dim": 128} if arch == "qwen3-0.6b" else {}))
    b = _batch(f.cfg, 2, 24, seed=5)
    want = _jax_grads(f, {k: jnp.asarray(v) for k, v in b.items()})
    set_trainable(f.model)
    loss, _ = forward_train(f.cfg, f.model, to_device(b, "cpu"), remat=False)
    loss.backward()
    got = export_grads(f.model)
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), want[key], err_msg=key, **GRAD_TOL)
    assert max(np.abs(w).max() for w in want.values()) > 1e-2


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mixtral-8x22b"])
def test_remat_gives_the_gradients_of_no_remat(arch, tmp_path):
    """Each stack step under torch.utils.checkpoint recomputes the same
    forward: loss, aux and every gradient as without it."""
    f = _pair(arch, tmp_path)
    b = to_device(_batch(f.cfg, 2, 16, seed=2), "cpu")
    set_trainable(f.model)
    out = {}
    for remat in (False, True):
        for p in f.model.parameters():
            p.grad = None
        loss, met = forward_train(f.cfg, f.model, b, remat=remat)
        loss.backward()
        out[remat] = (loss.detach(), met["aux_loss"].detach(), export_grads(f.model))
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=1e-7)
    torch.testing.assert_close(out[True][1], out[False][1], rtol=0, atol=1e-7)
    for key, g in out[False][2].items():
        torch.testing.assert_close(out[True][2][key], g, rtol=1e-6, atol=1e-8, msg=key)


def test_param_tree_roundtrip_and_assign(tmp_path):
    """``param_tree`` is ``export_params`` on the device; ``assign_params``
    writes a stacked tree back into every step's views; a wrong shape or a
    missing leaf raises."""
    f = _pair("llama-3.2-vision-90b", tmp_path)   # a repeated sub: (step, repeat) leaves
    tree = param_tree(f.model)
    exp = export_params(f.model)
    assert sorted(tree) == sorted(exp)
    for key in exp:
        np.testing.assert_array_equal(tree[key].numpy(), exp[key])
    new = {k: v + 1.0 for k, v in tree.items()}
    assign_params(f.model, new)
    for key, v in param_tree(f.model).items():
        torch.testing.assert_close(v, new[key], rtol=0, atol=0)
    bad = dict(new)
    key = next(k for k in bad if bad[k].dim() >= 2)
    bad[key] = bad[key][:1]
    with pytest.raises(ValueError, match="shape"):
        assign_params(f.model, bad)
    bad.pop(key)
    with pytest.raises(ValueError, match="missing"):
        assign_params(f.model, bad)


# --------------------------------------------------------------------------
# the train step, learning, checkpoints
# --------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches, tmp_path):
    """Two steps of ``make_train_step`` against the reference's (jit), on
    the same weights and batches: loss, grad_norm and lr; the forward's
    metrics averaged over the microbatches."""
    f = _pair("qwen2-0.5b", tmp_path)
    jopt = JaxAdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10, weight_decay=0.01)
    opt = AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10, weight_decay=0.01)
    jstep = jax.jit(jax_make_train_step(f.jcfg, jopt, remat=False, microbatches=microbatches))
    step = make_train_step(f.cfg, opt, remat=False, microbatches=microbatches)
    jp, js = f.jparams, jax_adamw_init(f.jparams)
    model, state = f.model, adamw_init(param_tree(f.model))
    ds = SyntheticLMDataset(f.cfg, DataConfig(batch_size=4, seq_len=16, seed=4))
    for i in range(2):
        b = ds.batch(i)
        jp, js, want = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        model, state, got = step(model, state, to_device(b, "cpu"))
        assert sorted(got) == sorted(want)
        for key in ("loss", "lm_loss", "aux_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(got[key]), float(want[key]), err_msg=key,
                                       **MODEL_TOL)
    assert int(state["step"]) == 2 and sorted(state["m"]) == sorted(param_tree(model))
    assert all(p.grad is None for p in model.parameters())


def test_microbatches_equal_one_batch(tmp_path):
    """Gradients accumulated over two halves, divided by two, are the whole
    batch's when the halves' losses weigh alike (same masked count): one
    step either way gives the same parameters."""
    f = _pair("qwen2-0.5b", tmp_path)
    (tmp_path / "second").mkdir()
    g = _pair("qwen2-0.5b", tmp_path / "second")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    b = to_device(_batch(f.cfg, 4, 16, seed=8), "cpu")
    outs = []
    for pair, n in ((f, 1), (g, 2)):
        step = make_train_step(pair.cfg, opt, remat=False, microbatches=n)
        model, _, met = step(pair.model, adamw_init(param_tree(pair.model)), b)
        outs.append((met, param_tree(model)))
    np.testing.assert_allclose(float(outs[1][0]["loss"]), float(outs[0][0]["loss"]), **TOL)
    np.testing.assert_allclose(float(outs[1][0]["grad_norm"]), float(outs[0][0]["grad_norm"]),
                               rtol=1e-5)
    for key, v in outs[0][1].items():
        torch.testing.assert_close(outs[1][1][key], v, rtol=1e-5, atol=1e-5, msg=key)


def test_model_learns_synthetic_data():
    """The counterpart of ``tests/test_substrate.py``'s: the loss drops by
    more than 0.5 over 45 steps on the structured stream."""
    cfg = get_config("qwen2-0.5b").reduced().with_overrides(
        n_layers=2, d_model=128, d_ff=256, vocab_size=256)
    model = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60, weight_decay=0.01)
    step = make_train_step(cfg, opt, remat=False)
    state = adamw_init(param_tree(model))
    ds = SyntheticLMDataset(cfg, DataConfig(batch_size=8, seq_len=64))
    losses = []
    for i in range(45):
        model, state, m = step(model, state, to_device(ds.batch(i), "cpu"))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_checkpoints_cross_the_packages_both_ways(tmp_path):
    """A reference checkpoint restores into the port's model and the port's
    into the reference's tree, each leaf equal; ``latest_step`` reads the
    other's files."""
    f = _pair("qwen3-0.6b", tmp_path)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_save_checkpoint(jdir, 7, f.jparams)
    assert latest_step(jdir) == 7
    other = init(f.cfg, torch.Generator().manual_seed(3), device="cpu")
    assign_params(other, restore_checkpoint(jdir, 7, param_tree(other)))
    ref = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
           for path, leaf in jax.tree_util.tree_flatten_with_path(f.jparams)[0]}
    for key, v in export_params(other).items():
        np.testing.assert_array_equal(v, ref[key], err_msg=key)

    path = save_checkpoint(tdir, 12, param_tree(other))
    assert path.endswith("state_00000012.npz") and jax_latest_step(tdir) == 12
    back = jax_restore_checkpoint(tdir, 12, f.jparams)
    got = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(leaf)
           for p, leaf in jax.tree_util.tree_flatten_with_path(back)[0]}
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    with pytest.raises(ValueError, match="mismatch"):
        restore_checkpoint(tdir, 12, {"tok_embed": np.zeros((1,), np.float32)})
    assert latest_step(str(tmp_path / "none")) is None


def test_prefill_and_serve_steps_are_the_models(tmp_path):
    f = _pair("qwen2-0.5b", tmp_path)
    toks = torch.from_numpy(_batch(f.cfg, 2, 12, seed=1)["tokens"])
    logits, caches = make_prefill_step(f.cfg)(f.model, {"tokens": toks})
    with torch.no_grad():
        full = forward_logits(f.cfg, f.model, {"tokens": toks})
    torch.testing.assert_close(logits, full[:, -1], **TOL)
    nxt, _ = make_serve_step(f.cfg)(f.model, caches, toks[:, -1], 12)
    assert nxt.shape == (2, f.cfg.vocab_size) and torch.isfinite(nxt).all()


# --------------------------------------------------------------------------
# the CLIs, and the card's refusals
# --------------------------------------------------------------------------

def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    model, m = train_cli.main(["--steps", "3", "--batch", "2", "--seq", "16", "--device",
                               "cpu", "--ckpt-dir", str(tmp_path), "--microbatches", "2"])
    assert latest_step(str(tmp_path)) == 3 and np.isfinite(float(m["loss"]))
    flat = restore_checkpoint(str(tmp_path), 3, param_tree(model))
    for key, v in export_params(model).items():
        np.testing.assert_array_equal(flat[key], v)


def test_train_lm_runs_checkpoints_and_resumes(tmp_path, capsys):
    """``train_lm`` at its small size: the loss falls over 20 steps, a
    checkpoint every 10; a second run to 25 steps resumes from step 20."""
    argv = ["--steps", "20", "--batch", "4", "--seq", "32", "--ckpt-every", "10",
            "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    model, first, final = train_lm.main(argv)
    assert final < first and latest_step(str(tmp_path)) == 20
    out = capsys.readouterr().out
    assert "checkpoint ->" in out and "done: 20 steps" in out
    argv[1] = "25"
    model2, _, _ = train_lm.main(argv)
    assert "resumed from checkpoint step 20" in capsys.readouterr().out
    _, _, none = train_lm.main(argv[:1] + ["20"] + argv[2:])
    assert none is None


@pytest.mark.parametrize("arch,what", [("falcon-mamba-7b", "mamba_scan"),
                                       ("recurrentgemma-2b", "rglru_scan"),
                                       ("deepseek-v2-lite-16b", "(192, 128)")])
def test_card_refuses_train_paths_without_a_backward_kernel(arch, what):
    """A train step on the card of falcon-mamba (mamba_scan) and
    recurrentgemma (rglru_scan, and flash attention at head_dim 256) raises
    before any step and names the ROADMAP item; deepseek, whose MLA
    attention at (192, 128) (``what``) has a backward instance, passes, at
    its published and its reduced (48, 32) widths, as do the other archs."""
    cfg = get_config(arch)
    if arch == "deepseek-v2-lite-16b":
        assert (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim) == (192, 128)
        assert what == str((192, 128)) and (192, 128) in fa.BWD_HEAD_DIMS
        for c in (cfg, cfg.reduced()):
            check_trainable_on_card(c)
            assert kernels_without_backward(c) == []
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP.md section 2") as e:
            check_trainable_on_card(cfg)
        assert what in str(e.value)
        if arch == "recurrentgemma-2b":
            assert "(256, 256)" in str(e.value)
    trainable = [a for a in ALL_ARCHS if not kernels_without_backward(get_config(a))]
    assert sorted(trainable) == sorted(set(ALL_ARCHS) - {"falcon-mamba-7b", "recurrentgemma-2b"})


def test_scan_kernels_refuse_to_run_under_grad_on_the_card(monkeypatch):
    """The scan wrappers raise where autograd would need a gradient through
    the kernel (the card), and run as before without grad."""
    u = torch.zeros(1, 4, 8, requires_grad=True)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(NotImplementedError, match="mamba_scan has no backward"):
        ops.mamba_scan_full(u, u, torch.zeros(1, 4, 2), torch.zeros(1, 4, 2),
                            torch.zeros(8, 2), torch.zeros(8))
    with pytest.raises(NotImplementedError, match="rglru_scan has no backward"):
        ops.rglru_scan_full(u, u)
