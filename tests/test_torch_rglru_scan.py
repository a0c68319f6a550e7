"""The RG-LRU scan kernel's work split and arithmetic, emulated on the CPU.

The CUDA kernel (``repro_torch/kernels/csrc/rglru_scan.cu``) runs only on
the card, where ``python3 chip_smoke.py`` holds it against
``rglru_scan_ref`` and checks two calls and a CUDA-graph replay bit for bit.
Here: the plan covers every (b, t, w) once, one block a (b, tile) walking
its chunks, and the grid fills the card at the paths' shapes with every
walking block resident at once; ``rglru_scan_chunked`` (the plan's local
pairs, in-block prefix, carry from chunk to chunk and re-walk, with torch
ops) agrees with repro's Pallas kernel in interpret mode and with the plain
versions; the wrapper's refusals; the wrapper's constants and the kernel's."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import rglru_scan as rs  # noqa: E402

H100_SMS = 132
TOL = dict(rtol=1e-4, atol=1e-4)        # tests/test_kernels.py::test_rglru_scan_sweep
# recurrentgemma-2b's split path, its 2304-token decode prefill, a scheduler
# cohort (chip_smoke.RS_PATHS)
PATHS = ((4, 512, 2560), (2, 2304, 2560), (4, 218, 2560))


def _inputs(B, S, W, seed, low=0.7, high=0.999):
    """a on U[low, high] and gx standard normal, as the JAX kernel sweep."""
    r = np.random.default_rng(seed)
    return (r.uniform(low, high, size=(B, S, W)).astype(np.float32),
            r.normal(size=(B, S, W)).astype(np.float32))


@pytest.mark.parametrize("B,S,W", PATHS + ((2, 200, 320), (1, 1, 100), (3, 4099, 2600),
                                           (1, 8192, 32)))
def test_plan_covers_every_b_t_w_once_with_one_block_walking_each_tile(B, S, W):
    p = rs.plan(B, S, W, H100_SMS)
    assert p.chunk == rs.STEPS * p.warps and p.blocks == B * p.tiles <= 2 ** 31 - 1
    assert 1 <= p.warps <= (rs.MAX_WARPS if p.chunks == 1 else rs.WALK_WARPS)
    assert (p.chunks - 1) * p.chunk < S <= p.chunks * p.chunk   # no chunk without work
    cover = np.zeros((B, S, W), dtype=np.int8)
    for i in range(p.blocks):
        b, tile = divmod(i, p.tiles)             # the kernel's block map (Plan)
        w0 = tile * rs.TILE
        assert w0 < W                              # no block without work
        for c in range(p.chunks):                  # the block's walk, in order
            for j in range(p.warps):
                t0 = c * p.chunk + j * rs.STEPS
                cover[b, t0:t0 + rs.STEPS, w0:w0 + rs.TILE] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("B,S,W", PATHS)
def test_plan_fills_the_card_at_the_paths_shapes(B, S, W):
    """Every SM gets a block (two where S fits one chunk: the split path and
    the cohort), and a walking plan's blocks (the prefill's 160 of 8 warps)
    are all resident at once: at most WALK_WARPS walking warps an SM."""
    p = rs.plan(B, S, W, H100_SMS)
    assert p.chunks == (18 if S == 2304 else 1)
    assert p.blocks >= (1 if p.chunks > 1 else 2) * H100_SMS
    if p.chunks > 1:
        assert -(-p.blocks // H100_SMS) * p.warps <= rs.WALK_WARPS


@pytest.mark.parametrize("B,S,W,sms", [(2, 1024, 256, H100_SMS), (1, 2304, 128, H100_SMS),
                                       (1, 2304, 256, 4), (2, 768, 256, 2)])
def test_chunked_emulation_matches_pallas_and_the_plain_versions(B, S, W, sms):
    a, gx = _inputs(B, S, W, seed=S + W)
    p = rs.plan(B, S, W, sms)
    assert p.chunks > 1
    y, h = rs.rglru_scan_chunked(torch.from_numpy(a), torch.from_numpy(gx), p)
    want_y, want_h = jax_rglru_scan(jnp.asarray(a), jnp.asarray(gx), interpret=True)
    oracle_y, oracle_h = jax_ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(gx))
    ref_y, ref_h = rs.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(gx))
    assert y.dtype == torch.float32 and y.shape == (B, S, W) and h.shape == (B, W)
    assert torch.equal(h, y[:, -1])
    for want, got in ((want_y, y), (want_h, h), (oracle_y, y), (oracle_h, h)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    torch.testing.assert_close(y, ref_y, **TOL)
    torch.testing.assert_close(h, ref_h, **TOL)


@pytest.mark.parametrize("B,S,W,sms,low,high", [
    (3, 1333, 70, H100_SMS, 0.7, 0.999),     # ragged tile and chunk, 16-warp chunks
    (2, 1000, 40, 1, 0.7, 0.999),            # 4-warp chunks, ragged last chunk
    (2, 700, 33, H100_SMS, 0.0, 1e-3),       # a ~ 0: every chunk's product underflows
    (1, 1, 100, H100_SMS, 0.7, 0.999)])      # one step, one chunk
def test_chunked_emulation_matches_the_plain_version_at_ragged_edges(B, S, W, sms, low, high):
    a, gx = _inputs(B, S, W, seed=B * S + W, low=low, high=high)
    p = rs.plan(B, S, W, sms)
    y, h = rs.rglru_scan_chunked(torch.from_numpy(a), torch.from_numpy(gx), p)
    ref_y, ref_h = rs.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(gx))
    oracle_y, _ = jax_ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(gx))
    assert torch.equal(h, y[:, -1]) and torch.isfinite(y).all()
    torch.testing.assert_close(y, ref_y, **TOL)
    torch.testing.assert_close(h, ref_h, **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(oracle_y), **TOL)
    if high <= 1e-3:                          # the chunk products are 0 in f32
        assert p.chunks > 1 and float(np.prod(a[:, :p.chunk], axis=1).max()) == 0.0


def test_wrapper_refuses_cpu_non_f32_non_contiguous_and_empty_inputs():
    a, gx = (torch.from_numpy(x) for x in _inputs(2, 5, 6, seed=4))
    before = rs.launches
    with pytest.raises(ValueError, match="CUDA"):
        rs.rglru_scan(a, gx)
    with pytest.raises(TypeError, match="float32"):
        rs.rglru_scan(a.half(), gx)
    with pytest.raises(ValueError, match="contiguous"):
        rs.rglru_scan(a.transpose(1, 2).contiguous().transpose(1, 2), gx)
    empty = torch.zeros(1, 5, 0)
    with pytest.raises(ValueError, match="out of range"):
        rs.rglru_scan(empty, empty)
    assert rs.launches == before


def test_wrapper_constants_are_the_kernels():
    source = (_build.SRC_DIR / "rglru_scan.cu").read_text()
    for name in ("TILE", "STEPS", "MAX_WARPS", "WALK_WARPS"):
        m = re.search(rf"constexpr int {name} = (\d+);", source)
        assert m and int(m.group(1)) == getattr(rs, name), name
