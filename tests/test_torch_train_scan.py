"""The scans' backward on the CPU: falcon-mamba-7b's selective scan and
recurrentgemma-2b's RG-LRU under autograd, against ``repro``.

The plain backwards (``mamba_scan_bwd_ref``, ``rglru_scan_bwd_ref``) are
explicit reverse recurrences; they are the backward kernels' oracles on the
card (chip_smoke.py phase 2), so they are held here against autograd in f64
and against ``jax.vjp`` of the reference's scans. ``mamba_scan_bwd_chunked``
runs the mamba backward kernel's chunk plan (saved chunk-start states,
re-run, reverse walk, partial sums by tile) with torch ops. The autograd
Functions run the plain versions on CPU tensors; on the card they launch the
kernels (the kernels themselves run only on the card: chip_smoke.py). The two families' gradients go leaf by
leaf against ``jax.grad``, and the C entry points' ctypes signatures are
read from their CUDA sources."""
import ctypes
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpointing import load_tree as jax_load_tree  # noqa: E402
from repro.checkpointing import save_tree as jax_save_tree  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.ref import rglru_scan_ref as jax_rglru_scan_ref  # noqa: E402
from repro.models import forward_train as jax_forward_train  # noqa: E402
from repro.models import init as jax_init  # noqa: E402
from repro.models.ssm import ssm_scan_chunked as jax_ssm_scan_chunked  # noqa: E402

from repro_torch.checkpointing import load_tree, save_tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMDataset, to_device  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import rglru_scan as rs  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import export_grads, forward_train, load_jax_params  # noqa: E402
from repro_torch.models import set_trainable  # noqa: E402
from repro_torch.models.ssm import SSMMixer  # noqa: E402

# the plain backwards against an exact oracle (f64 autograd, or jax.vjp of
# the reference in f32): f32 sums in other orders over S steps, held at
# 2e-5 of each gradient's largest magnitude
REL = 2e-5
# the mixer's scan path against jax.vjp of the reference's: the
# projections and softplus add f32 sums of their own
MIXER_TOL = dict(rtol=5e-4, atol=5e-4)
# jax.grad of the reference's loss against the port's autograd, leaf by
# leaf (as tests/test_torch_train.py holds the other families)
GRAD_TOL = dict(rtol=1e-3, atol=2e-6)
NONZERO = ("scale", "bias", "conv_b", "b_a", "b_x")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    gap = np.abs(got - want).max() / scale
    assert gap <= rel, f"{what}: {gap:.3g} of the largest magnitude {scale:.3g} (tol {rel})"


def _scan_inputs(B, S, DI, N, seed, dtype=np.float32):
    """u normal; dt in the model's range (0.001-0.1); Bm and Cm as slices of
    one (B, S, 3 + 2N) projection, as the mixer passes them; A = -exp(normal);
    the cotangents of y and h_final."""
    r = np.random.default_rng(seed)
    u = r.normal(size=(B, S, DI))
    dt = r.uniform(0.001, 0.1, size=(B, S, DI))
    xdbc = r.normal(size=(B, S, 3 + 2 * N))
    A = -np.exp(r.normal(size=(DI, N)))
    dy, dh = r.normal(size=(B, S, DI)), r.normal(size=(B, DI, N))
    return [a.astype(dtype) for a in (u, dt, xdbc, A, dy, dh)]


def _views(xdbc, N):
    return xdbc[..., 3:3 + N], xdbc[..., 3 + N:]


# (B, S, DI, N): ragged S against the 32-step chunk, N of 4, 8, 16 and 32
# (one to eight lanes a channel; 16-step chunks at N 32), N 5 with DI 100
MAMBA_CASES = [(2, 37, 24, 4), (1, 45, 40, 8), (2, 33, 32, 16), (1, 50, 24, 32),
               (1, 45, 100, 5)]


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("case", MAMBA_CASES)
def test_mamba_plain_backward_matches_f64_autograd(case, with_dh):
    """``mamba_scan_bwd_ref`` in f32 against autograd of ``mamba_scan_ref``
    in f64, with and without a gradient on h_final."""
    B, S, DI, N = case
    u, dt, xdbc, A, dy, dh = _scan_inputs(B, S, DI, N, seed=sum(case) + with_dh)
    t64 = [torch.from_numpy(a).double().requires_grad_() for a in (u, dt, xdbc, A)]
    Bm, Cm = _views(t64[2], N)
    y, h = ref.mamba_scan_ref(t64[0], t64[1], Bm, Cm, t64[3])
    loss = (y * torch.from_numpy(dy).double()).sum()
    if with_dh:
        loss = loss + (h * torch.from_numpy(dh).double()).sum()
    want = torch.autograd.grad(loss, (t64[0], t64[1], Bm, Cm, t64[3]))
    tu, tdt, tx, tA = (torch.from_numpy(a) for a in (u, dt, xdbc, A))
    got = ref.mamba_scan_bwd_ref(tu, tdt, *_views(tx, N), tA, torch.from_numpy(dy),
                                 torch.from_numpy(dh) if with_dh else None)
    assert [g.dtype for g in got] == [torch.float32] * 5
    for name, g, w in zip(("du", "ddt", "dBm", "dCm", "dA"), got, want):
        assert g.shape == w.shape, name
        _close(g.numpy(), w.numpy(), what=name)


@pytest.mark.parametrize("case", MAMBA_CASES + [(2, 70, 140, 16), (1, 21, 300, 4)])
def test_mamba_chunk_plan_matches_plain_backward(case):
    """The backward kernel's plan with torch ops (chunk-start states every
    ``CHUNK_STEPS`` steps, each chunk re-run and walked in reverse, the
    ragged last one padded with steps that leave g and h as they are, g
    carried across chunks, dB and dC summed by tiles of channels, then the
    tiles and dA's batch rows in order) gives the plain backward, at tiles
    of 32 channels (several tiles at every case) and of 256, the kernel's
    widest block (one tile but at DI 300)."""
    B, S, DI, N = case
    u, dt, xdbc, A, dy, dh = (torch.from_numpy(a) for a in
                              _scan_inputs(B, S, DI, N, seed=3 * sum(case)))
    Bm, Cm = _views(xdbc, N)
    assert S > ms.CHUNK_STEPS
    want = ref.mamba_scan_bwd_ref(u, dt, Bm, Cm, A, dy, dh)
    for tile in (32, 256):
        got = ms.mamba_scan_bwd_chunked(u, dt, Bm, Cm, A, dy, dh, tile=tile)
        for name, g, w in zip(("du", "ddt", "dBm", "dCm", "dA"), got, want):
            _close(g.numpy(), w.numpy(), what=f"{name} (tiles of {tile})")


def _mixer(cfg, seed):
    """An SSM mixer of ``cfg`` with its leaves drawn from ``seed`` (numpy),
    and the reference's leaves of its scan."""
    di, n, r = cfg.d_inner, cfg.ssm_state, cfg.resolved_dt_rank
    g = np.random.default_rng(seed)
    leaves = {
        "in_proj": g.normal(size=(cfg.d_model, 2 * di)) * 0.05,
        "conv_w": g.normal(size=(cfg.ssm_conv, di)) * 0.1, "conv_b": g.normal(size=di) * 0.1,
        "x_proj": g.normal(size=(di, r + 2 * n)) * di ** -0.5,
        "dt_proj": g.normal(size=(r, di)) * r ** -0.5,
        "dt_bias": -4.6 + 0.5 * g.normal(size=di),
        "a_log": np.log(np.arange(1, n + 1))[None].repeat(di, 0) + 0.1 * g.normal(size=(di, n)),
        "d_skip": 1.0 + 0.2 * g.normal(size=di),
        "out_proj": g.normal(size=(di, cfg.d_model)) * 0.05}
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    return SSMMixer(cfg, {k: torch.from_numpy(v) for k, v in leaves.items()}), leaves


SCAN_LEAVES = ("x_proj", "dt_proj", "dt_bias", "a_log", "d_skip")


@pytest.mark.parametrize("S", [24, 45])
def test_mixer_scan_path_with_mamba_fn_matches_jax_vjp(S):
    """The SSM mixer's scan path on the train route: ``ssm_params`` (Bm and
    Cm strided views of the x_proj output, as the Function takes them),
    ``MambaScanFn`` (its CPU route: the plain forward, then the plain
    backward) and the D-skip, against ``jax.vjp`` of
    ``repro.models.ssm.ssm_scan_chunked`` with respect to u and the layer's
    leaves, cotangents on y and h_final, within 5e-4."""
    cfg = get_config("falcon-mamba-7b").reduced()
    jcfg = jax_get_config("falcon-mamba-7b").reduced()
    mixer, leaves = _mixer(cfg, seed=S)
    r = np.random.default_rng(S + 1)
    u = r.normal(size=(2, S, cfg.d_inner)).astype(np.float32)
    dy = r.normal(size=u.shape).astype(np.float32)
    dh = r.normal(size=(2, cfg.d_inner, cfg.ssm_state)).astype(np.float32)

    p = {k: jnp.asarray(leaves[k]) for k in SCAN_LEAVES}
    (want_y, want_h), vjp = jax.vjp(lambda p_, u_: jax_ssm_scan_chunked(jcfg, p_, u_), p,
                                    jnp.asarray(u))
    want_p, want_u = vjp((jnp.asarray(dy), jnp.asarray(dh)))

    for name in SCAN_LEAVES:
        getattr(mixer, name).requires_grad_()
    ut = torch.from_numpy(u).requires_grad_()
    dt, Bm, Cm = mixer.ssm_params(ut)
    assert not (Bm.is_contiguous() or Cm.is_contiguous()) and Bm.stride(-1) == 1
    y, h = ms.MambaScanFn.apply(ut, dt, Bm, Cm, -torch.exp(mixer.a_log))
    y = y + ut * mixer.d_skip
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **MIXER_TOL)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h), **MIXER_TOL)
    ((y * torch.from_numpy(dy)).sum() + (h * torch.from_numpy(dh)).sum()).backward()
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(want_u), err_msg="u", **MIXER_TOL)
    for name in SCAN_LEAVES:
        g = getattr(mixer, name).grad
        np.testing.assert_allclose(g.numpy(), np.asarray(want_p[name]), err_msg=name,
                                   **MIXER_TOL)
        assert np.abs(np.asarray(want_p[name])).max() > 1e-4, name


def test_mamba_fn_on_the_cpu_is_the_plain_path():
    """``MambaScanFn`` on CPU tensors: the plain forward, and as gradients
    those of autograd through the plain forward; no kernel launches; the
    kernels' wrappers refuse CPU tensors and the backward a bf16 u."""
    B, S, DI, N = 2, 40, 24, 8
    u, dt, xdbc, A, dy, dh = (torch.from_numpy(a) for a in _scan_inputs(B, S, DI, N, seed=4))
    before = (ms.launches, ms.bwd_launches)
    leaves = [t.clone().requires_grad_() for t in (u, dt, xdbc, A)]
    y, h = ms.MambaScanFn.apply(leaves[0], leaves[1], *_views(leaves[2], N), leaves[3])
    ((y * dy).sum() + (h * dh).sum()).backward()
    auto = [t.clone().requires_grad_() for t in (u, dt, xdbc, A)]
    y2, h2 = ref.mamba_scan_ref(auto[0], auto[1], *_views(auto[2], N), auto[3])
    ((y2 * dy).sum() + (h2 * dh).sum()).backward()
    assert torch.equal(y, y2) and torch.equal(h, h2)
    for a, b in zip(leaves, auto):
        _close(a.grad.numpy(), b.grad.numpy())
    assert (ms.launches, ms.bwd_launches) == before
    Bm, Cm = _views(xdbc, N)
    hc = torch.zeros(B, -(-S // ms.CHUNK_STEPS), DI, N)
    with pytest.raises(ValueError, match="CUDA"):
        ms.mamba_scan_bwd(u, dt, Bm, Cm, A, hc, dy)
    with pytest.raises(TypeError, match="float32"):
        ms.mamba_scan_bwd(u.bfloat16(), dt, Bm, Cm, A, hc, dy)
    with pytest.raises(ValueError, match="h_chunks"):
        ms.mamba_scan_bwd(u, dt, Bm, Cm, A, hc[:, :1], dy)
    assert (ms.launches, ms.bwd_launches) == before


# (B, S, W): one step, ragged tiles, the train shape cut down
RGLRU_CASES = [(1, 1, 40), (2, 17, 33), (2, 64, 96)]


@pytest.mark.parametrize("case", RGLRU_CASES)
def test_rglru_plain_backward_matches_jax_vjp(case):
    """``rglru_scan_bwd_ref`` from the forward's h_seq against ``jax.vjp`` of
    ``repro.kernels.ref.rglru_scan_ref`` (its associative scan), cotangents
    on h_seq and h_last, within 2e-5 of each gradient's largest magnitude;
    and without a cotangent on h_last."""
    B, S, W = case
    r = np.random.default_rng(sum(case))
    a = r.uniform(0.7, 0.999, size=(B, S, W)).astype(np.float32)
    gx, dy = (r.normal(size=(B, S, W)).astype(np.float32) for _ in range(2))
    dh = r.normal(size=(B, W)).astype(np.float32)
    (wy, wh), vjp = jax.vjp(jax_rglru_scan_ref, jnp.asarray(a), jnp.asarray(gx))
    ta = torch.from_numpy(a)
    y, h = ref.rglru_scan_ref(ta, torch.from_numpy(gx))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=REL, atol=REL)
    for cot_h in (dh, np.zeros_like(dh)):
        want = vjp((jnp.asarray(dy), jnp.asarray(cot_h)))
        got = ref.rglru_scan_bwd_ref(ta, y, torch.from_numpy(dy),
                                     torch.from_numpy(cot_h) if cot_h is dh else None)
        for name, g, w in zip(("da", "dgx"), got, want):
            _close(g.numpy(), np.asarray(w), what=name)


def test_rglru_fn_on_the_cpu_is_the_plain_path_and_the_plan_is_bounded():
    """``RglruScanFn`` on CPU tensors gives autograd's gradients of the plain
    forward and launches nothing; the kernel's wrapper refuses CPU tensors;
    the backward's plan keeps at most BWD_WARPS warps a block and covers S."""
    B, S, W = 2, 50, 40
    r = np.random.default_rng(8)
    a = torch.from_numpy(r.uniform(0.7, 0.999, size=(B, S, W)).astype(np.float32))
    gx, dy = (torch.from_numpy(r.normal(size=(B, S, W)).astype(np.float32)) for _ in range(2))
    dh = torch.from_numpy(r.normal(size=(B, W)).astype(np.float32))
    before = (rs.launches, rs.bwd_launches)
    outs = []
    for fn in (rs.RglruScanFn.apply, ref.rglru_scan_ref):
        la, lg = a.clone().requires_grad_(), gx.clone().requires_grad_()
        y, h = fn(la, lg)
        ((y * dy).sum() + (h * dh).sum()).backward()
        outs.append((y.detach(), la.grad, lg.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    for g, w in zip(outs[0][1:], outs[1][1:]):
        _close(g.numpy(), w.numpy())
    assert (rs.launches, rs.bwd_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        rs.rglru_scan_bwd(a, outs[0][0], dy)
    for B_, S_, W_ in ((4, 512, 2560), (2, 2304, 2560), (1, 256, 32), (1, 257, 32),
                       (3, 4099, 2600), (1, 1, 1)):
        p = rs.bwd_plan(B_, S_, W_, 132)
        assert 1 <= p.warps <= rs.BWD_WARPS and p.chunk == rs.STEPS * p.warps
        assert p.chunks * p.chunk >= S_ > (p.chunks - 1) * p.chunk
        assert p.blocks == B_ * -(-W_ // rs.TILE)


# --------------------------------------------------------------------------
# the two families' gradients against jax.grad
# --------------------------------------------------------------------------

def _pair(arch, tmp_path, seed=0, **overrides):
    """One reduced model in both packages from one .npz file, its norm
    scales, biases and conv biases drawn away from the init's ones and
    zeros from ``seed``."""
    jcfg = jax_get_config(arch).reduced().with_overrides(**overrides)
    cfg = get_config(arch).reduced().with_overrides(**overrides)
    p0, p1 = tmp_path / f"{arch}-0.npz", tmp_path / f"{arch}-1.npz"
    params = jax_init(jcfg, jax.random.key(seed))
    jax_save_tree(str(p0), params)
    flat, _ = load_tree(str(p0))
    r = np.random.default_rng(seed + 11)
    for key in sorted(flat):
        if key.rsplit("/", 1)[-1] in NONZERO:
            base = 1.0 if key.endswith("scale") else 0.0
            flat[key] = (base + 0.2 * r.normal(size=flat[key].shape)).astype(flat[key].dtype)
    save_tree(str(p1), flat)
    jparams, _ = jax_load_tree(str(p1), params)
    return cfg, jcfg, jparams, load_jax_params(cfg, flat, device="cpu")


@pytest.mark.parametrize("route", ["autograd", "functions"])
@pytest.mark.parametrize("arch,layers", [("falcon-mamba-7b", 2), ("recurrentgemma-2b", 3)])
def test_family_gradients_match_jax_grad_leaf_by_leaf(arch, layers, route, tmp_path,
                                                      monkeypatch):
    """Every gradient leaf of reduced falcon-mamba and of reduced
    recurrentgemma at 3 layers (rec, rec and its local attention) against
    ``jax.grad`` of the reference's loss within GRAD_TOL: through autograd of
    the plain scans (the CPU's train route), and through ``MambaScanFn`` and
    ``RglruScanFn`` with their plain backwards (the card's route, with the
    plain versions standing in for the kernels)."""
    cfg, jcfg, jparams, model = _pair(arch, tmp_path, n_layers=layers)
    b = SyntheticLMDataset(cfg, DataConfig(batch_size=2, seq_len=24, seed=5)).batch(0)
    fn = lambda p: jax_forward_train(jcfg, p, {k: jnp.asarray(v) for k, v in b.items()},  # noqa: E731
                                     remat=False)[0]
    g = jax.grad(fn)(jparams)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]}
    calls = {"mamba": 0, "rglru": 0}
    if route == "functions":
        def mamba(*a):
            calls["mamba"] += 1
            return ms.MambaScanFn.apply(*a)

        def rglru(*a):
            calls["rglru"] += 1
            return rs.RglruScanFn.apply(*a)
        monkeypatch.setattr(ops.ref, "mamba_scan_ref", mamba)
        monkeypatch.setattr(ops.ref, "rglru_scan_ref", rglru)
    set_trainable(model)
    loss, _ = forward_train(cfg, model, to_device(b, "cpu"), remat=False)
    loss.backward()
    got = export_grads(model)
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), want[key], err_msg=key, **GRAD_TOL)
    assert max(np.abs(w).max() for w in want.values()) > 1e-2
    if route == "functions":   # two scan layers in either model
        assert calls == ({"mamba": 2, "rglru": 0} if cfg.ssm else {"mamba": 0, "rglru": 2})


# --------------------------------------------------------------------------
# the C entry points (the dispatch to the Functions on the card:
# tests/test_torch_train.py::test_scan_kernels_refuse_to_run_under_grad_on_the_card)
# --------------------------------------------------------------------------

def _c_argtypes(source, name):
    """ctypes argtypes of C entry point ``name``, read from its source: long
    long* a pointer to c_longlong, any other pointer c_void_p, float
    c_float, int c_int."""
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', source).group(1)
    want = []
    for p in params.split(","):
        p = p.replace(" *", "*")
        want.append(ctypes.POINTER(ctypes.c_longlong) if "long long*" in p else
                    ctypes.c_void_p if "*" in p else
                    ctypes.c_float if p.split()[0] == "float" else ctypes.c_int)
    return want


@pytest.mark.parametrize("module,source,entry,getter", [
    (ms, "mamba_scan", "mamba_scan_fwd", "_entry"),
    (ms, "mamba_scan", "mamba_scan_bwd", "_bwd_entry"),
    (ms, "mamba_scan", "mamba_scan_bwd_scratch", "_scratch_entry"),
    (rs, "rglru_scan", "rglru_scan_fwd", "_entry"),
    (rs, "rglru_scan", "rglru_scan_bwd", "_bwd_entry")])
def test_ctypes_signatures_follow_the_scan_sources(monkeypatch, module, source, entry, getter):
    """The scan wrappers' argtypes follow their C entry points' parameters,
    read from the CUDA sources (the forward's h_chunks pointer, the
    backwards' workspace pointers)."""
    text = (_build.SRC_DIR / f"{source}.cu").read_text()
    want = _c_argtypes(text, entry)
    lib = types.SimpleNamespace(**{entry: types.SimpleNamespace()})
    monkeypatch.setattr(_build, "library", lambda n: lib if n == source else None)
    get = getattr(module, getter)
    get.cache_clear()
    try:
        fn = get()
    finally:
        get.cache_clear()
    assert fn.argtypes == want and fn.restype is ctypes.c_int
    assert source in _build.KERNELS
