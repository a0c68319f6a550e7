"""The flash attention kernel's plain version against repro's Pallas kernel
(interpret mode) and its oracle (CPU), at head dims 64 and 256, plus the
rules every kernel wrapper (flash_attention, flash_decode, mamba_scan,
quant_matmul, rglru_scan) keeps on the CPU, and the arithmetic of three
kernels emulated on the CPU: flash_attention's 3xTF32 products,
flash_decode's split-and-merge over the ring and mamba_scan's four states a
lane with its exp2 of the prescaled A.
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


# --- the arithmetic of the two attention kernels, pinned on the CPU --------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to nearest on the
    13 dropped significand bits, ties away from zero (the bits are sign and
    magnitude, so adding half an ulp to the magnitude rounds it so)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, passes):
    """a @ b on TF32 tensor cores: one product of the rounded operands, or
    the 3xTF32 split x = big + small, a_small b_big + a_big b_small +
    a_big b_big (the kernel's order), each accumulated in f32."""
    ab, bb = _tf32(a), _tf32(b)
    if passes == 1:
        return ab @ bb
    return _tf32(a - ab) @ bb + ab @ _tf32(b - bb) + ab @ bb


def _attention_tf32(q, k, v, *, causal, window, passes):
    """The flash_attention kernel's f32 arithmetic: QK^T and PV through
    ``_mm_tf32``, softmax in f32 with the finite -1e30 and exp2, kv head
    h % HK."""
    B, H, S, D = q.shape
    HK = k.shape[1]
    idx = torch.arange(H) % HK
    kh, vh = k[:, idx], v[:, idx]
    s = _mm_tf32(q, kh.transpose(-1, -2), passes) * (D ** -0.5 * 1.4426950408889634)
    i = torch.arange(S)
    ok = torch.ones(S, S, dtype=torch.bool)
    if causal:
        ok &= i[None, :] <= i[:, None]
    if window is not None:
        ok &= i[:, None] - i[None, :] < window
    s = torch.where(ok, s, torch.tensor(-1e30))
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    return _mm_tf32(p, vh, passes) / p.sum(-1, keepdim=True).clamp_min(1e-30)


@pytest.mark.parametrize("B,H,HK,S,D,causal,window", [
    (2, 14, 2, 40, 64, True, None),       # qwen2's heads, ragged S
    (2, 14, 2, 512, 64, True, None),      # the split path's S
    (2, 14, 2, 512, 128, False, None),    # head_dim 128, no mask
    (2, 10, 1, 256, 256, True, 64),       # recurrentgemma: MQA, D 256, window
    (2, 4, 2, 100, 256, True, None)])     # D 256, h % HK != h // G
def test_3xtf32_attention_keeps_f32_accuracy_and_one_tf32_pass_does_not(
        B, H, HK, S, D, causal, window):
    """The kernel's f32 route: three TF32 products per f32 product stay
    within the 2e-5 of the chip checks; a single TF32 product does not."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(B, H, HK, S, D, seed=S + D))
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    three = _attention_tf32(q, k, v, causal=causal, window=window, passes=3)
    one = _attention_tf32(q, k, v, causal=causal, window=window, passes=1)
    torch.testing.assert_close(three, want, **TOL)
    assert (one - want).abs().max() > 2e-5


def test_tf32_rounding_is_round_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, -(1.0 + 2 ** -11),
                      1.0 + 2 ** -12, 3.0e-3], dtype=torch.float32)
    got = _tf32(x)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10), 1.0,
                         float(np.float32(3.0e-3))], dtype=torch.float32)
    torch.testing.assert_close(got[:5], want[:5], rtol=0, atol=0)
    # 11 significant bits kept: within half a TF32 ulp, low 13 bits zero
    assert abs(got[5].item() - 3.0e-3) <= 3.0e-3 * 2 ** -11
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    # the split is exact to 2^-22: big + small reproduces x
    r = torch.from_numpy(np.random.default_rng(0).normal(size=1000).astype(np.float32))
    big = _tf32(r)
    assert ((big + _tf32(r - big)) - r).abs().le(r.abs() * 2 ** -21).all()


def _decode_by_splits(q, k, v, pos, window, sms, group=lambda h, HK, G: h % HK,
                      empty_split=False):
    """flash_decode's arithmetic: ``fd.plan``'s chunks of the visible arc
    (distance d from the query at slot (pos - d) mod C), an online softmax in
    log2 units per split, then the merge of the splits' (m, l, acc) with
    weights exp2(m_s - m_all). ``group`` maps query head h to its kv head;
    ``empty_split`` adds a split that saw no slot (m = -1e30, l = 0)."""
    B, H, D = q.shape
    HK, C = k.shape[1], k.shape[2]
    G = H // HK
    p = fd.plan(B, H, HK, C, D, pos, window, sms)
    nchunks = -(-p.nvis // p.chunk)
    out = torch.empty_like(q)
    for b in range(B):
        for hk in range(HK):
            heads = [h for h in range(H) if group(h, HK, G) == hk]
            qs = q[b, heads] * (D ** -0.5 * 1.4426950408889634)
            parts = []
            for sp in range(p.splits):
                m = torch.full((G,), -1e30)
                l, acc = torch.zeros(G), torch.zeros(G, D)
                for c in range(sp * p.per_split, min((sp + 1) * p.per_split, nchunks)):
                    dist = torch.arange(c * p.chunk, min((c + 1) * p.chunk, p.nvis))
                    slots = (pos - dist) % C
                    s = qs @ k[b, hk, slots].T
                    m_new = torch.maximum(m, s.amax(1))
                    alpha = torch.exp2(m - m_new)
                    pr = torch.exp2(s - m_new[:, None])
                    l = l * alpha + pr.sum(1)
                    acc = acc * alpha[:, None] + pr @ v[b, hk, slots]
                    m = m_new
                parts.append((m, l, acc))
            if empty_split:
                parts.append((torch.full((G,), -1e30), torch.zeros(G), torch.zeros(G, D)))
            m_all = torch.stack([m for m, _, _ in parts]).amax(0)
            w = [torch.exp2(m - m_all) for m, _, _ in parts]
            den = sum(wi * l for wi, (_, l, _) in zip(w, parts))
            num = sum(wi[:, None] * acc for wi, (_, _, acc) in zip(w, parts))
            out[b, heads] = num / den.clamp_min(1e-30)[:, None]
    return out, p


@pytest.mark.parametrize("B,H,HK,C,D,pos,window", [
    (8, 14, 2, 576, 64, 575, None),       # qwen2's decode path: 9 splits of 64 slots
    (2, 10, 1, 2048, 256, 2404, 2048),    # recurrentgemma's: wrapped full ring
    (2, 10, 1, 2048, 64, 3000, 96),       # window 96 in a wrapped 2048-slot ring
    (2, 14, 2, 200, 64, 450, None),       # C = 200, no multiple of a chunk
    (1, 40, 2, 256, 64, 300, None),       # G = 20: two groups of query heads
    (2, 4, 2, 48, 32, 10, None)])         # a partly filled ring
@pytest.mark.parametrize("empty_split", [False, True])
def test_decode_splits_merged_by_the_kernels_rule_equal_the_plain_version(
        B, H, HK, C, D, pos, window, empty_split):
    r = np.random.default_rng(C + pos)
    q, k, v = (torch.from_numpy(r.normal(size=s).astype(np.float32))
               for s in ((B, H, D), (B, HK, C, D), (B, HK, C, D)))
    got, p = _decode_by_splits(q, k, v, pos, window, sms=132, empty_split=empty_split)
    torch.testing.assert_close(got, fd.flash_decode_ref(q, k, v, pos, window=window), **TOL)
    assert p.nvis == min(pos + 1, C, window or C)


def test_decode_splits_group_query_heads_as_h_mod_hk():
    """The block of kv head hk holds query heads hk, hk + HK, ...: grouping
    them as h // G instead gives another answer."""
    B, H, HK, C, D, pos = 2, 14, 2, 200, 64, 150
    r = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(r.normal(size=s).astype(np.float32))
               for s in ((B, H, D), (B, HK, C, D), (B, HK, C, D)))
    want = fd.flash_decode_ref(q, k, v, pos)
    by_mod, _ = _decode_by_splits(q, k, v, pos, None, sms=132)
    by_div, _ = _decode_by_splits(q, k, v, pos, None, sms=132,
                                  group=lambda h, HK, G: h // G)
    torch.testing.assert_close(by_mod, want, **TOL)
    assert (by_div - want).abs().max() > 0.1


@pytest.mark.parametrize("B,H,HK,C,D,pos,window,blocks", [
    (8, 14, 2, 576, 64, 575, None, 144),     # qwen2-0.5b's decode path
    (2, 10, 1, 2048, 256, 2404, 2048, 128)])  # recurrentgemma-2b's
def test_decode_plan_fills_the_card_and_covers_the_arc_once(B, H, HK, C, D, pos, window, blocks):
    p = fd.plan(B, H, HK, C, D, pos, window, sms=132)
    assert p.units * p.splits == blocks >= 128
    # the C entry point's own check: every split holds at least one slot
    assert (p.splits - 1) * p.per_split * p.chunk < p.nvis <= p.splits * p.per_split * p.chunk
    assert p.chunk * D <= 4096 and p.chunk >= max(8, 512 // D)



@pytest.mark.parametrize("sms", [8, 78, 114, 132])
def test_decode_workspace_holds_every_plan(sms):
    """The per-stream workspace is made once at one size: every plan that
    splits, at any batch, head grouping, ring, head dim and position, fits
    in it, so it never has to grow under a captured CUDA graph."""
    n_part, n_count = fd._workspace_size(sms)
    rng = np.random.default_rng(sms)
    seen = 0
    for _ in range(2000):
        HK = int(rng.integers(1, 9))
        H = HK * int(rng.integers(1, 41))
        B, C = int(rng.integers(1, 17)), int(rng.integers(1, 5000))
        D = int(rng.choice(fd.HEAD_DIMS))
        pos = int(rng.integers(0, 3 * C))
        window = None if rng.random() < 0.5 else int(rng.integers(1, 3000))
        p = fd.plan(B, H, HK, C, D, pos, window, sms)
        if p.splits > 1:
            seen += 1
            assert p.units * p.splits * fd.GROUP * (D + 2) <= n_part
            assert p.units <= n_count
    assert seen > 100

def test_build_target_hashes_the_shared_headers(monkeypatch, tmp_path):
    """A library is rebuilt when a header its source may include changes."""
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    before = _build._target("k")
    (tmp_path / "common.cuh").write_text("// two\n")
    assert _build._target("k") != before


def _mamba_kernel_emulation(u, dt, Bm, Cm, A):
    """The CUDA mamba_scan's f32 arithmetic, one batch row: four states a
    thread (P = ceil(N / 4) lanes a channel), exp(dt * A) as exp2 of dt
    times the prescaled A log2 e, h = dA * h + (dt * u) * B, the lane's
    partial y over its four states, and the deferred sum over lanes: at P
    = 8 lanes q and q + 4 meet first, then the write-out adds the (up to
    four) partials as (p0 + p1) + (p2 + p3)."""
    f32 = np.float32
    S, DI = u.shape
    N = A.shape[1]
    P = 1 << max(0, (-(-N // 4) - 1).bit_length())
    a2 = np.zeros((DI, 4 * P), f32)
    a2[:, :N] = A * f32(1.4426950408889634)
    pad = lambda m: np.pad(m, ((0, 0), (0, 4 * P - N)))  # noqa: E731
    Bp, Cp = pad(Bm), pad(Cm)
    h = np.zeros((DI, 4 * P), f32)
    y = np.zeros((S, DI), f32)
    for t in range(S):
        dtu = dt[t] * u[t]
        h = np.exp2(dt[t][:, None] * a2) * h + dtu[:, None] * Bp[t][None, :]
        hc = (h * Cp[t][None, :]).reshape(DI, P, 4)
        p = ((hc[..., 0] + hc[..., 1]) + hc[..., 2]) + hc[..., 3]      # (DI, P)
        if P == 8:
            p = p[:, :4] + p[:, 4:]
        if p.shape[1] == 4:
            y[t] = (p[:, 0] + p[:, 1]) + (p[:, 2] + p[:, 3])
        elif p.shape[1] == 2:
            y[t] = p[:, 0] + p[:, 1]
        else:
            y[t] = p[:, 0]
    return y, h[:, :N]


@pytest.mark.parametrize("falcon_a,N", [(True, 16), (False, 16), (False, 32), (False, 5),
                                        (False, 4)])
def test_mamba_kernel_arithmetic_holds_the_plain_version_at_s512(falcon_a, N):
    """Four states a lane, the exp as exp2 of the prescaled A, the y sum
    split over lanes: within 1e-4 of mamba_scan_ref over 512 steps, with
    falcon-mamba's A = -(1..16) and with random A = -exp(normal), at one,
    two, four and eight lanes a channel."""
    S, DI = 512, 48
    r = np.random.default_rng(16)
    u = r.normal(size=(S, DI)).astype(np.float32)
    dt = r.uniform(0.001, 0.1, size=(S, DI)).astype(np.float32)
    Bm, Cm = (r.normal(size=(S, N)).astype(np.float32) for _ in range(2))
    A = (-np.tile(np.arange(1, N + 1, dtype=np.float32), (DI, 1)) if falcon_a
         else -np.exp(r.normal(size=(DI, N))).astype(np.float32))
    y, h = _mamba_kernel_emulation(u, dt, Bm, Cm, A)
    want_y, want_h = ms.mamba_scan_ref(*(torch.from_numpy(a)[None] for a in (u, dt, Bm, Cm)),
                                       torch.from_numpy(A))
    np.testing.assert_allclose(y, want_y[0].numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h, want_h[0].numpy(), rtol=1e-4, atol=1e-4)
