"""The int8 matmul kernel's work split and arithmetic, emulated on the CPU.

The CUDA kernel (``repro_torch/kernels/csrc/quant_matmul.cu``) runs only on
the card, where ``python3 chip_smoke.py`` holds it bit for bit against
``quant_matmul_ref``. Here: the split-K plan covers every (k, n) once and
fills the card at qwen2-0.5b's decode shapes; the plan's int32 partials,
summed in any order and rescaled once, give the plain version (and the JAX
reference) bit for bit; the regime choice; and the w8a8 leaves' codes,
laid out K-major once when a version is built (the order the kernel
reads, so no call copies them), with the values, size, export and link
bytes of the JAX layout."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.quant_matmul import quant_matmul_ref as jax_quant_matmul_ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quant_matmul as qmm  # noqa: E402
from repro_torch.models import export_params, init  # noqa: E402
from repro_torch.models.layers import Dense  # noqa: E402
from repro_torch.quant import build_version_params, quantize  # noqa: E402
from repro_torch.serving import SplitServingEngine  # noqa: E402

H100_SMS = 132
# qwen2-0.5b's seven w8 projections, (K, N)
QWEN2_LAYER = ((896, 896), (896, 128), (896, 128), (896, 896),
               (896, 4864), (896, 4864), (4864, 896))


def _blocks(p, M, N, K):
    """The (m rows, k rows, n columns) ranges of a split plan's blocks, in
    the kernel's grid order (n tile, split, m tile)."""
    for mz in range(-(-M // p.mt)):
        for split in range(p.splits):
            for nx in range(-(-N // p.bn)):
                yield (range(mz * p.mt, min(M, (mz + 1) * p.mt)),
                       range(split * p.per_rows, min(K, (split + 1) * p.per_rows)),
                       range(nx * p.bn, min(N, (nx + 1) * p.bn)))


@pytest.mark.parametrize("K,N", sorted(set(QWEN2_LAYER)))
def test_split_plan_covers_every_k_n_once_and_fills_the_card_at_qwen2_decode(K, N):
    M = 8                                   # qwen2-0.5b's w8 decode step
    p = qmm.split_plan(M, N, K, H100_SMS)
    cover = np.zeros((M, K, N), dtype=np.int32)
    for ms, ks, ns in _blocks(p, M, N, K):
        assert len(ks) > 0                 # no split is empty
        cover[ms.start:ms.stop, ks.start:ks.stop, ns.start:ns.stop] += 1
    assert (cover == 1).all()
    assert p.blocks >= H100_SMS
    assert p.per_rows % qmm.KROWS == 0
    n_part, n_count = qmm._workspace_size(H100_SMS)
    if p.splits > 1:                        # the workspace holds the plan
        assert p.tiles < H100_SMS and p.tiles * p.mt * p.bn <= n_part and p.tiles <= n_count


@pytest.mark.parametrize("M,K,N,sms", [(8, 200, 72, 16), (3, 4864, 896, H100_SMS),
                                       (37, 100, 200, 24), (16, 896, 128, H100_SMS)])
def test_split_partials_summed_in_any_order_and_rescaled_once_are_bit_exact(M, K, N, sms):
    r = np.random.default_rng(M * 7 + K + N)
    xq = r.integers(-128, 128, size=(M, K)).astype(np.int8)
    wq = r.integers(-128, 128, size=(K, N)).astype(np.int8)
    xs = r.uniform(1e-4, 0.05, size=M).astype(np.float32)
    ws = r.uniform(1e-4, 0.05, size=N).astype(np.float32)
    p = qmm.split_plan(M, N, K, sms)
    assert p.splits > 1
    partials = [(ms, ns, (xq[ms.start:ms.stop, ks.start:ks.stop].astype(np.int32)
                          @ wq[ks.start:ks.stop, ns.start:ns.stop].astype(np.int32)))
                for ms, ks, ns in _blocks(p, M, N, K)]
    want = qmm.quant_matmul_ref(*(torch.from_numpy(a) for a in (xq, wq, xs, ws))).numpy()
    np.testing.assert_array_equal(
        want, np.asarray(jax_quant_matmul_ref(*(jnp.asarray(a) for a in (xq, wq, xs, ws)))))
    for seed in range(3):                   # the atomics land in any order
        acc = np.zeros((M, N), dtype=np.int32)
        for i in np.random.default_rng(seed).permutation(len(partials)):
            ms, ns, part = partials[i]
            acc[ms.start:ms.stop, ns.start:ns.stop] += part
        # the epilogue, once on the complete sum: (float(acc) * xs[m]) * ws[n]
        got = (acc.astype(np.float32) * xs[:, None]) * ws[None, :]
        np.testing.assert_array_equal(got, want)


def test_regime_choice():
    # large M: wgmma, the largest tiles that give the card one an SM
    p = qmm.plan(4096, 4864, 896, H100_SMS)
    assert (p.regime, p.mt, p.bn, p.splits, p.tiles) == ("wgmma", 128, 128, 1, 1216)
    assert qmm.plan(4096, 896, 896, H100_SMS)[1:3] == (128, 128)
    assert qmm.plan(4096, 128, 896, H100_SMS)[1:3] == (64, 128)
    # small M: wgmma while its busiest block walks at most WG_WALK_MAX steps
    # of K, the split regime over deeper K (qwen2's down projection, the
    # falcon-mamba head at decode)
    assert qmm.plan(8, 4864, 896, H100_SMS).regime == "wgmma"
    assert qmm.plan(8, 896, 4864, H100_SMS).regime == "split"
    assert qmm.plan(2, 65024, 4096, H100_SMS).regime == "split"
    # TMA needs K % 16 == 0 and aligned operands; else the split regime, at any M
    assert qmm.plan(4096, 200, 100, H100_SMS).regime == "split"
    assert qmm.plan(4096, 896, 896, H100_SMS, aligned=False).regime == "split"
    for M in (1, 8, 64, 65, 4096):
        for K, N in set(QWEN2_LAYER):
            assert qmm.plan(M, N, K, H100_SMS).regime in ("split", "wgmma")


def test_quant_matmul_refuses_cpu_tensors_with_a_k_major_copy():
    x = torch.zeros(4, 32, dtype=torch.int8)
    w = torch.zeros(32, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        qmm.quant_matmul(x, w.t().contiguous().t(), torch.ones(4), torch.ones(8))
    assert qmm.launches == 0
    # the kernel's operand: a view of a K-major weight, a copy of any other
    k_major = w.t().contiguous().t()
    assert qmm._k_major(k_major).data_ptr() == k_major.data_ptr()
    assert qmm._k_major(k_major).is_contiguous()
    assert qmm._k_major(w).data_ptr() != w.data_ptr()
    assert torch.equal(qmm._k_major(w), w.t())


@pytest.fixture(scope="module")
def w8_model():
    cfg = get_config("qwen2-0.5b").reduced()
    model = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    exported = export_params(model)
    versions = build_version_params(cfg, model, ("bf16", "w8"))
    return cfg, model, exported, versions


def _w8_leaves(model):
    return [m for m in model.modules() if isinstance(m, Dense) and m.weight is None]


def test_k_major_copy_is_made_once_per_w8a8_leaf(w8_model):
    _, model, _, versions = w8_model
    leaves = _w8_leaves(versions["w8"])
    assert leaves and not _w8_leaves(model)
    floats = dict(model.named_modules())
    held = {}
    for name, leaf in versions["w8"].named_modules():
        if leaf not in leaves:
            continue
        # the codes of quantize, in K-major order: the kernel's view, no copy
        assert leaf.act_bits == 8 and leaf.q.t().is_contiguous()
        assert not leaf.q.is_contiguous()
        want = quantize(floats[name].w, "w8a8")
        assert want.q.is_contiguous() and torch.equal(leaf.q, want.q)
        assert leaf.w.q is leaf.q            # the leaf hands its codes on
        assert qmm._k_major(leaf.w.q).data_ptr() == leaf.q.data_ptr()
        held[name] = (leaf.q, leaf.q.data_ptr())
    assert len(held) == len(leaves)
    for _ in range(2):                       # calls lay out nothing anew
        with torch.inference_mode():
            for leaf in leaves:
                x = torch.randn(3, leaf.q.shape[0])
                ops.quantized_dense(x, leaf.w)
    for name, leaf in versions["w8"].named_modules():
        if name in held:
            t, ptr = held[name]
            assert leaf.q is t and leaf.q.data_ptr() == ptr
    # weight-only leaves keep quantize's layout
    assert Dense(quantize(torch.randn(64, 32), "w8wo")).q.is_contiguous()
    assert Dense(quantize(torch.randn(64, 32), "w4")).q.is_contiguous()


def test_k_major_copy_leaves_size_export_and_link_bytes_unchanged(w8_model):
    cfg, model, exported, versions = w8_model
    # the float model's export is untouched by building the version
    after = export_params(model)
    assert sorted(after) == sorted(exported)
    assert all(np.array_equal(after[k], exported[k]) for k in exported)
    for leaf in _w8_leaves(versions["w8"]):
        w = leaf.w
        assert w.nbytes == w.q.numel() + 4 * w.scale.numel()
        assert w.q.untyped_storage().nbytes() == w.q.numel()   # one layout, no second copy
        state = leaf.state_dict()
        assert sorted(state) == ["q", "scale"] and tuple(state["q"].shape) == tuple(w.q.shape)
    # what crosses the link: int8 codes plus one f32 scale a row
    eng = SplitServingEngine(cfg, model, ("w8",), device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24))
    _, act_bytes = eng.infer({"tokens": tokens}, ("main", 1), "w8")
    assert act_bytes == 2 * 24 * cfg.d_model + 2 * 24 * 4
