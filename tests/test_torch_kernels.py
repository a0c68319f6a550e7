"""The flash attention kernel's plain version against repro's Pallas kernel
(interpret mode) and its oracle (CPU), at head dims 64 and 256, plus the
rules every kernel wrapper (flash_attention, flash_decode, mamba_scan,
quant_matmul, rglru_scan) keeps on the CPU.
The CUDA kernels themselves run only on the card: ``python3 chip_smoke.py``
holds them against these plain versions there."""
import ctypes
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_decode import flash_decode as jax_flash_decode  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import quant_matmul as qmm  # noqa: E402
from repro_torch.kernels import rglru_scan as rs  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(B, H, HK, S, D, seed):
    r = np.random.default_rng(seed)
    return tuple(r.normal(size=shape).astype(np.float32)
                 for shape in ((B, H, S, D), (B, HK, S, D), (B, HK, S, D)))


@pytest.mark.parametrize("B,H,HK,S,D", [(2, 4, 2, 32, 64),     # GQA 4/2
                                        (1, 14, 2, 40, 64),    # 14/2, ragged S
                                        (1, 10, 1, 40, 256),   # recurrentgemma: MQA, D 256
                                        (1, 4, 2, 24, 256)])   # D 256, h % HK != h // G
@pytest.mark.parametrize("causal,window", [(True, None), (True, 16), (False, None)])
def test_flash_attention_ref_matches_pallas_and_oracle(B, H, HK, S, D, causal, window):
    q, k, v = _qkv(B, H, HK, S, D, seed=S + H)
    got = fa.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=causal, window=window).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want_kernel = np.asarray(jax_flash(jq, jk, jv, causal=causal, window=window,
                                       interpret=True))
    want_ref = np.asarray(jax_ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                                      window=window))
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)


def test_flash_attention_ref_reads_kv_head_h_mod_hk():
    """Query head h reads kv head h % HK (the reference's (G, HK) grouping),
    not h // G (torch's repeat_interleave / SDPA enable_gqa)."""
    B, H, HK, S, D = 1, 4, 2, 16, 64
    q, k, v = _qkv(B, H, HK, S, D, seed=5)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = fa.flash_attention_ref(tq, tk, tv, causal=True)
    by_mod = fa.flash_attention_ref(tq, tk.repeat(1, H // HK, 1, 1),
                                    tv.repeat(1, H // HK, 1, 1), causal=True)
    by_div = fa.flash_attention_ref(tq, tk.repeat_interleave(H // HK, 1),
                                    tv.repeat_interleave(H // HK, 1), causal=True)
    torch.testing.assert_close(got, by_mod, **TOL)
    assert (got - by_div).abs().max() > 0.1
    want = np.asarray(jax_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                                interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("B,H,HK,C,pos,window", [
    (2, 10, 1, 64, 40, None),      # MQA, partly filled ring
    (1, 10, 1, 64, 150, 64),       # MQA, wrapped ring, window = C
    (1, 4, 2, 48, 100, 32)])       # h % HK != h // G, wrapped, window < C
def test_flash_decode_ref_matches_pallas_at_head_dim_256(B, H, HK, C, pos, window):
    r = np.random.default_rng(C + pos)
    q, k, v = (r.normal(size=s).astype(np.float32)
               for s in ((B, H, 256), (B, HK, C, 256), (B, HK, C, 256)))
    want = jax_flash_decode(*(jnp.asarray(a) for a in (q, k, v)), jnp.int32(pos),
                            window=window, interpret=True)
    got = fd.flash_decode_ref(*(torch.from_numpy(a) for a in (q, k, v)), pos, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ops_dispatch_cpu_tensors_to_the_plain_versions():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 8, 64, seed=1))
    before = fa.launches
    out = ops.attention_bhsd(q, k, v, causal=True)
    torch.testing.assert_close(out, fa.flash_attention_ref(q, k, v, causal=True))
    assert fa.launches == before


def test_flash_attention_kernel_refuses_what_it_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 8, 64, seed=2))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, v)
    assert fa.launches == 0


def test_flash_decode_kernel_refuses_what_it_does_not_take():
    def qkv(B=1, H=4, HK=2, C=16, D=64, dtype=torch.float32, kdtype=None):
        return (torch.zeros(B, H, D, dtype=dtype),
                torch.zeros(B, HK, C, D, dtype=kdtype or dtype),
                torch.zeros(B, HK, C, D, dtype=kdtype or dtype))
    with pytest.raises(ValueError, match="CUDA"):
        fd.flash_decode(*qkv(), 5)
    with pytest.raises(TypeError, match="dtypes"):
        fd.flash_decode(*qkv(kdtype=torch.bfloat16), 5)
    with pytest.raises(TypeError, match="dtypes"):
        fd.flash_decode(*qkv(dtype=torch.float16), 5)
    with pytest.raises(ValueError, match="head dim"):
        fd.flash_decode(*qkv(D=96), 5)
    with pytest.raises(ValueError, match="vs k/v"):
        fd.flash_decode(*qkv(H=6, HK=4), 5)
    q, k, v = qkv()
    with pytest.raises(ValueError, match="contiguous"):
        fd.flash_decode(q, torch.zeros(1, 2, 16, 128)[..., ::2], v, 5)
    with pytest.raises(ValueError, match="pos"):
        fd.flash_decode(q, k, v, -1)
    with pytest.raises(ValueError, match="window"):
        fd.flash_decode(q, k, v, 5, window=0)
    assert fd.launches == 0


def _scan_args(B=2, S=5, DI=6, N=4, seed=3):
    r = np.random.default_rng(seed)
    return tuple(torch.from_numpy(a.astype(np.float32)) for a in (
        r.normal(size=(B, S, DI)), r.uniform(0.001, 0.1, size=(B, S, DI)),
        r.normal(size=(B, S, N)), r.normal(size=(B, S, N)), r.normal(size=(DI, N))))


def test_ops_mamba_scan_full_dispatches_cpu_tensors_to_the_plain_version():
    u, dt, Bm, Cm, a_log = _scan_args()
    d_skip = torch.linspace(0.5, 1.5, u.shape[-1])
    before = ms.launches
    for uu in (u, u.to(torch.bfloat16)):
        y, h = ops.mamba_scan_full(uu, dt, Bm, Cm, a_log, d_skip)
        want_y, want_h = ms.mamba_scan_ref(uu.float(), dt, Bm, Cm, -torch.exp(a_log))
        assert y.dtype == uu.dtype and h.dtype == torch.float32
        torch.testing.assert_close(y, (want_y + uu.float() * d_skip).to(uu.dtype))
        torch.testing.assert_close(h, want_h)
    assert ms.launches == before


def test_mamba_scan_kernel_refuses_what_it_does_not_take():
    u, dt, Bm, Cm, A = _scan_args()
    with pytest.raises(ValueError, match="CUDA"):
        ms.mamba_scan(u, dt, Bm, Cm, A)
    with pytest.raises(TypeError, match="u is"):
        ms.mamba_scan(u.half(), dt, Bm, Cm, A)
    with pytest.raises(TypeError, match="float32"):
        ms.mamba_scan(u, dt, Bm.to(torch.bfloat16), Cm, A)
    with pytest.raises(ValueError, match="shapes"):
        ms.mamba_scan(u, dt[:, :4], Bm, Cm, A)
    with pytest.raises(ValueError, match="shapes"):
        ms.mamba_scan(u, dt, Bm, Cm, A[:5])
    big = _scan_args(N=33)
    with pytest.raises(ValueError, match="state size"):
        ms.mamba_scan(*big)
    with pytest.raises(ValueError, match="contiguous"):
        ms.mamba_scan(u.transpose(0, 1).contiguous().transpose(0, 1), dt, Bm, Cm, A)
    with pytest.raises(ValueError, match="state dim"):
        ms.mamba_scan(u, dt, Bm, torch.zeros(2, 5, 8)[..., ::2], A)
    assert ms.launches == 0


def test_rglru_scan_kernel_refuses_what_it_does_not_take():
    r = np.random.default_rng(4)
    a, gx = (torch.from_numpy(r.uniform(0.5, 1.0, size=(2, 5, 6)).astype(np.float32))
             for _ in range(2))
    with pytest.raises(ValueError, match="CUDA"):
        rs.rglru_scan(a, gx)
    with pytest.raises(TypeError, match="float32"):
        rs.rglru_scan(a.to(torch.bfloat16), gx)
    with pytest.raises(TypeError, match="float32"):
        rs.rglru_scan(a, gx.double())
    with pytest.raises(ValueError, match="shapes"):
        rs.rglru_scan(a, gx[:, :4])
    with pytest.raises(ValueError, match="shapes"):
        rs.rglru_scan(a[0], gx[0])
    with pytest.raises(ValueError, match="out of range"):
        rs.rglru_scan(a[:, :0], gx[:, :0])
    with pytest.raises(ValueError, match="contiguous"):
        rs.rglru_scan(a.transpose(1, 2).contiguous().transpose(1, 2), gx)
    assert rs.launches == 0


def _c_signature(source: str, fn: str):
    """ctypes types of an ``extern "C"`` function's parameters, read from
    its CUDA source."""
    m = re.search(rf'extern "C" int {fn}\(([^)]*)\)', source)
    assert m, fn
    types = []
    for param in m.group(1).split(","):
        if "long long*" in param.replace(" *", "*"):
            types.append(ctypes.POINTER(ctypes.c_longlong))
        elif "*" in param:
            types.append(ctypes.c_void_p)
        elif param.split()[0] == "float":
            types.append(ctypes.c_float)
        else:
            assert param.split()[0] == "int", param
            types.append(ctypes.c_int)
    return types


@pytest.mark.parametrize("module,name,fn", [
    (fa, "flash_attention", "flash_attention_fwd"),
    (fd, "flash_decode", "flash_decode_fwd"),
    (ms, "mamba_scan", "mamba_scan_fwd"),
    (qmm, "quant_matmul", "quant_matmul_s8"),
    (rs, "rglru_scan", "rglru_scan_fwd")])
def test_ctypes_signatures_match_the_c_entry_points(monkeypatch, module, name, fn):
    lib = types.SimpleNamespace(**{fn: types.SimpleNamespace()})
    monkeypatch.setattr(_build, "library", lambda n: lib if n == name else None)
    module._entry.cache_clear()
    try:
        entry = module._entry()
    finally:
        module._entry.cache_clear()
    source = (_build.SRC_DIR / f"{name}.cu").read_text()
    assert entry.argtypes == _c_signature(source, fn)
    assert entry.restype is ctypes.c_int


def test_a_missing_compiler_raises_and_nothing_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["quant_matmul"])
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library("flash_attention")
    assert "flash_attention" not in _build._LIBS
    with pytest.raises(KeyError):
        _build.build(["no_such_kernel"])
