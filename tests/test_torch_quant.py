"""repro_torch.quant and the int8 matmul's plain version against repro
(CPU). Codes and scales must match bit for bit; the int8 product exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.quant_matmul import quant_matmul as jax_quant_matmul  # noqa: E402
from repro.kernels.quant_matmul import quant_matmul_ref as jax_quant_matmul_ref  # noqa: E402
from repro.quant import quantize as jax_quantize  # noqa: E402
from repro.quant import quantize_act as jax_quantize_act  # noqa: E402
from repro.quant.quantize import _pack_int4 as jax_pack_int4  # noqa: E402
from repro_torch.kernels import quant_matmul as qmm  # noqa: E402
from repro_torch.quant import (build_version_params, get_version,  # noqa: E402
                               quantize, quantize_act)
from repro_torch.quant.quantize import _pack_int4, _unpack_int4  # noqa: E402


@pytest.mark.parametrize("mode", ["w8wo", "w4", "w8a8"])
@pytest.mark.parametrize("shape", [(256, 512), (2, 64, 96), (40, 24)])
def test_quantize_matches_reference_bit_for_bit(mode, shape):
    w = np.random.default_rng(7).normal(size=shape).astype(np.float32) * 0.05
    ref = jax_quantize(jnp.asarray(w), mode)
    got = quantize(torch.from_numpy(w), mode)
    assert (got.bits, got.act_bits) == (ref.bits, ref.act_bits)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    # scales agree to the last bit (same IEEE f32 amax / qmax)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(got.dequantize().numpy(),
                                  np.asarray(ref.dequantize()))
    assert got.nbytes == ref.nbytes


def test_int4_pack_roundtrip_and_nibble_order():
    codes = np.random.default_rng(3).integers(-8, 8, size=(3, 64, 17)).astype(np.int8)
    packed = _pack_int4(torch.from_numpy(codes))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_pack_int4(jnp.asarray(codes))))
    assert packed.dtype == torch.uint8 and packed.shape == (3, 32, 17)
    # low nibble = even row
    np.testing.assert_array_equal(packed.numpy()[:, 0] & 0xF, codes[:, 0] & 0xF)
    np.testing.assert_array_equal(_unpack_int4(packed).numpy(), codes)


@pytest.mark.parametrize("shape", [(4, 16, 256), (37, 896)])
def test_quantize_act_matches_reference(shape):
    x = np.random.default_rng(11).normal(size=shape).astype(np.float32) * 3.0
    x[0, ...] = 0.0                                   # all-zero row: clamp at 1e-8
    qr, sr = jax_quantize_act(jnp.asarray(x))
    qg, sg = quantize_act(torch.from_numpy(x))
    np.testing.assert_array_equal(qg.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(sg.numpy(), np.asarray(sr))


@pytest.mark.parametrize("M,K,N", [(37, 896, 128), (5, 64, 40)])
def test_quant_matmul_ref_matches_pallas_kernel_and_oracle(M, K, N):
    r = np.random.default_rng(M * K + N)
    xq = r.integers(-127, 128, size=(M, K)).astype(np.int8)
    wq = r.integers(-127, 128, size=(K, N)).astype(np.int8)
    xs = r.uniform(1e-3, 0.1, size=(M,)).astype(np.float32)
    ws = r.uniform(1e-3, 0.1, size=(N,)).astype(np.float32)
    jargs = tuple(jnp.asarray(a) for a in (xq, wq, xs, ws))
    got = qmm.quant_matmul_ref(*(torch.from_numpy(a) for a in (xq, wq, xs, ws))).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_quant_matmul_ref(*jargs)))
    np.testing.assert_array_equal(got, np.asarray(jax_quant_matmul(*jargs, interpret=True)))


def test_quant_matmul_kernel_refuses_cpu_tensors():
    x = torch.zeros(4, 32, dtype=torch.int8)
    w = torch.zeros(32, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        qmm.quant_matmul(x, w, torch.ones(4), torch.ones(8))
    assert qmm.launches == 0


def test_versions_registry_and_build():
    from repro.quant import get_version as jax_get_version
    for name in ("bf16", "w8", "w4"):
        ours, ref = get_version(name), jax_get_version(name)
        assert (ours.weight_bits, ours.act_bits, ours.mode) == (
            ref.weight_bits, ref.act_bits, ref.mode)
    with pytest.raises(KeyError):
        get_version("w2")
    from repro_torch.configs import get_config
    from repro_torch.models import init
    from repro_torch.models.layers import Dense
    cfg = get_config("qwen2-0.5b").reduced()
    model = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    out = build_version_params(cfg, model)
    assert out["bf16"] is model
    blk = out["w8"].stacks["main"][0].blk
    assert blk.attn.wq.act_bits == 8 and blk.mlp.w_down.bits == 8
    assert out["w4"].stacks["main"][1].blk.mlp.w_up.bits == 4
    assert out["w8"].tok_embed is model.tok_embed      # shared, stays float
    assert out["w8"].stacks["main"][0].blk.attn.bq is model.stacks["main"][0].blk.attn.bq
    # the source model is left as it was
    assert all(isinstance(m.w, torch.Tensor) for m in model.modules()
               if isinstance(m, Dense))
