"""Each cost function against counts made by hand at small shapes."""
import pytest

from edgebench import costs
from edgebench.costs import flash_attention, infer, mamba_scan, quant_matmul
from edgebench.tests.small import small_config


def test_flash_attention_by_hand():
    # B 1, S 4, H 2, HK 1, D = Dv = 2, causal: 1 + 2 + 3 + 4 = 10 pairs a head
    c = flash_attention.cost(1, 4, 2, 1, 2, 2, None)
    assert c["f32_flops"] == 2 * (2 * 10) * (2 + 2)
    # q 4x2x2, k 4x1x2, v 4x1x2, out 4x2x2 floats
    assert c["bytes"] == 4 * (16 + 8 + 8 + 16)
    # a window of 2: pairs 1 + 2 + 2 + 2
    assert flash_attention.visible_pairs(4, 2) == 7
    assert flash_attention.visible_pairs(4, 8) == 10


def test_quant_matmul_by_hand():
    c = quant_matmul.cost(3, 5, 7)
    assert c["int8_ops"] == 2 * 3 * 5 * 7
    assert c["bytes"] == 3 * 5 + 5 * 7 + 4 * 3 + 4 * 7 + 4 * 3 * 7


def test_mamba_scan_by_hand():
    c = mamba_scan.cost(2, 3, 4, 5)
    assert c["exps"] == 2 * 3 * 4 * 5
    # u, dt, y: 2x3x4 each; B, C: 2x3x5 each; A 4x5; h 2x4x5
    assert c["bytes"] == 4 * (3 * 24 + 2 * 30 + 20 + 40)


def test_bounds_take_the_larger_term():
    p = costs.peaks()
    c = {"int8_ops": p["int8_ops_per_s"], "bytes": 1.0}
    assert quant_matmul.bound_s(c, p) == pytest.approx(1.0)
    c = {"exps": 1.0, "bytes": p["hbm_bytes_per_s"] * 2}
    assert mamba_scan.bound_s(c, p) == pytest.approx(2.0)


def test_infer_dense_by_hand():
    config = small_config("starcoder2-3b")
    m = config["model"]
    d, H, HK, Dh, f, V, L = (m[k] for k in ("d_model", "n_heads", "n_kv_heads", "head_dim",
                                           "d_ff", "vocab_size", "n_layers"))
    B, S = 2, 3
    proj = 2 * B * S * (d * H * Dh + 2 * d * HK * Dh + H * Dh * d + 2 * d * f)
    attn = 2 * B * H * (S * (S + 1) // 2) * 2 * Dh
    head = 2 * B * S * d * V
    w8 = infer.cost(config, B, S, "w8")
    assert w8 == {"f32_flops": L * attn, "int8_ops": L * proj + head}
    f32 = infer.cost(config, B, S, "bf16")
    assert f32 == {"f32_flops": L * (attn + proj) + head, "int8_ops": 0.0}
    assert infer.cost(config, B, S, "w4") == f32
    assert infer.launches(config, "w8") == {"flash_attention": L, "quant_matmul": 6 * L + 1,
                                            "mamba_scan": 0}
    assert infer.launches(config, "bf16")["quant_matmul"] == 0


def test_infer_ssm_by_hand():
    config = small_config("falcon-mamba-7b")
    m = config["model"]
    d, V, L, n, r = m["d_model"], m["vocab_size"], m["n_layers"], m["ssm_state"], m["resolved_dt_rank"]
    di = m["ssm_expand"] * d
    B, S = 1, 5
    layer = 2 * B * S * (d * 2 * di + di * (r + 2 * n) + r * di + di * d)
    head = 2 * B * S * d * V
    assert infer.cost(config, B, S, "w8") == {"f32_flops": L * layer, "int8_ops": head}
    assert infer.cost(config, B, S, "w4") == {"f32_flops": L * layer + head, "int8_ops": 0.0}
    assert infer.launches(config, "w8") == {"flash_attention": 0, "quant_matmul": 1,
                                            "mamba_scan": L}
