"""repro_torch's Griffin hybrid path against repro on reduced
recurrentgemma-2b (CPU), at 5 layers: one (rec, rec, attn) period plus the
2-layer rec tail (plain ``.reduced()`` has 3 layers and no tail). The
RG-LRU scan kernel's plain version against repro's Pallas kernel
(interpret mode), its oracle and a numpy loop; the RG-LRU mixer in every
mode, the GeGLU MLP, model logits (jnp path and Pallas interpret), split
execution and split serving at every cut, quantization of the DENSE_WEIGHTS
leaves only, prefill caches and decode across a wrapped local-window ring,
ServingEngine and ContinuousBatchingServer, the parameter plan and inits.
Weights cross as a ``save_tree`` .npz file. The CUDA kernel runs only on
the card: ``python3 chip_smoke.py`` holds it against ``rglru_scan_ref``
there."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpointing import save_tree as jax_save_tree  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.partition import cut_for_layer as jax_cut_for_layer  # noqa: E402
from repro.core.partition import cut_points as jax_cut_points  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward_logits as jax_forward_logits  # noqa: E402
from repro.models import init as jax_init  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models.layers import apply_mlp as jax_apply_mlp  # noqa: E402
from repro.models.model import abstract_params as jax_abstract_params  # noqa: E402
from repro.models.model import cache_axes as jax_cache_axes  # noqa: E402
from repro.models.rglru import apply_rec as jax_apply_rec  # noqa: E402
from repro.quant.quantize import QTensor as JaxQTensor  # noqa: E402
from repro.quant.quantize import quantize_tree as jax_quantize_tree  # noqa: E402
from repro.serving import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving import SplitServingEngine as JaxSplitServingEngine  # noqa: E402
from repro.serving.scheduler import ContinuousBatchingServer as JaxServer  # noqa: E402
from repro.serving.scheduler import Request as JaxRequest  # noqa: E402
from repro_torch.checkpointing import flatten, load_tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.partition import cut_for_layer, cut_points, split_forward  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rglru_scan as rs  # noqa: E402
from repro_torch.models import (cache_axes, decode_step, export_params,  # noqa: E402
                                forward_logits, init, init_cache,
                                load_jax_params, plan_model, prefill)
from repro_torch.models.layers import MLP, Dense  # noqa: E402
from repro_torch.models.rglru import RecMixer  # noqa: E402
from repro_torch.quant import QTensor, build_version_params  # noqa: E402
from repro_torch.quant.quantize import DENSE_WEIGHTS  # noqa: E402
from repro_torch.serving import (ContinuousBatchingServer, Request,  # noqa: E402
                                 ServeConfig, ServingEngine, SplitServingEngine)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "recurrentgemma-2b"
LAYERS = 5                                 # one period + the 2-layer rec tail
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)      # tests/test_kernels.py::test_rglru_scan_sweep
LAYER_TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=5e-4, atol=5e-4)
CACHE_TOL = dict(rtol=2e-5, atol=2e-5)
# w8: an f32 difference upstream of quantize_act can flip one int8 code by
# one step (tests/test_torch_ssm.py), at the link or inside a w8a8 matmul
# of the trunk. In this model a flipped code before a rec block reaches the
# conv window's K = 4 positions and then every later position through the
# decaying RG-LRU state (and the local attention). Measured at this size
# (2 x 24 tokens): cuts ('period', 1) and ('tail', 0) 3e-7; ('tail', 1) max
# 7.9e-3, mean 1.4e-4; ('tail', 2) max 8.6e-3, mean 1.65e-4, spread over
# most positions of one row. So the ssm test's bounds hold here too: max
# 2e-2, mean K x 1e-4 = 4e-4, 18x below w8's own quantization error at this
# size (w8 against bf16 logits: mean 7.1e-3).
W8_MAX, W8_MEAN = 2e-2, 4 * 1e-4
FULL_PARAMS = 2_894_574_080


def _configs(**kw):
    jcfg = jax_get_config(ARCH).reduced().with_overrides(n_layers=LAYERS, **kw)
    cfg = get_config(ARCH).reduced().with_overrides(n_layers=LAYERS, **kw)
    return jcfg, cfg


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """Reduced recurrentgemma at 5 layers: reference params, and the same
    weights in the port through a reference-written .npz."""
    jcfg, cfg = _configs()
    params = jax_init(jcfg, jax.random.key(0))
    path = str(tmp_path_factory.mktemp("npz") / "recurrentgemma.npz")
    jax_save_tree(path, params)
    flat, _ = load_tree(path)
    return jcfg, cfg, params, load_jax_params(cfg, flat, device="cpu"), flat


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _scan_inputs(B, S, W, seed):
    r = np.random.default_rng(seed)
    return (r.uniform(0.7, 0.999, size=(B, S, W)).astype(np.float32),
            r.normal(size=(B, S, W)).astype(np.float32))


def _numpy_scan(a, gx, h0=None):
    h = np.zeros(a[:, 0].shape, np.float32) if h0 is None else h0.copy()
    ys = np.zeros_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + gx[:, t]
        ys[:, t] = h
    return ys, h


@pytest.mark.parametrize("B,S,W", [(1, 128, 256), (2, 256, 512), (1, 384, 128)])
def test_rglru_scan_ref_matches_pallas_and_oracle(B, S, W):
    a, gx = _scan_inputs(B, S, W, seed=S + W)
    want_y, want_h = jax_rglru_scan(jnp.asarray(a), jnp.asarray(gx), interpret=True)
    oracle_y, oracle_h = jax_ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(gx))
    y, h = rs.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(gx))
    assert y.dtype == torch.float32 and y.shape == (B, S, W) and h.shape == (B, W)
    for want, got in ((want_y, y), (want_h, h), (oracle_y, y), (oracle_h, h)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)


def test_rglru_scan_ref_ragged_and_h0_match_numpy_loop():
    """S = 200 and W = 320 fit no 128 tile (the TPU kernel asserts tiles);
    a start state h0 carries on the recurrence."""
    a, gx = _scan_inputs(2, 200, 320, seed=9)
    want_y, want_h = _numpy_scan(a, gx)
    y, h = rs.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(gx))
    np.testing.assert_allclose(y.numpy(), want_y, **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), want_h, **SCAN_TOL)
    h0 = torch.from_numpy(_numpy_scan(a[:, :77], gx[:, :77])[1])
    y2, h2 = rs.rglru_scan_ref(torch.from_numpy(a[:, 77:]), torch.from_numpy(gx[:, 77:]), h0=h0)
    np.testing.assert_allclose(y2.numpy(), want_y[:, 77:], **SCAN_TOL)
    np.testing.assert_allclose(h2.numpy(), want_h, **SCAN_TOL)


def test_ops_rglru_scan_full_dispatches_cpu_tensors_to_the_plain_version():
    a, gx = (torch.from_numpy(x) for x in _scan_inputs(2, 5, 6, seed=3))
    before = rs.launches
    y, h = ops.rglru_scan_full(a, gx)
    want_y, want_h = rs.rglru_scan_ref(a, gx)
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(h, want_h, rtol=0, atol=0)
    assert rs.launches == before


def _mixer_params(params, rng, stack="period", sub="s0"):
    """Layer 0's mixer of one rec sub, with non-trivial biases, so every
    term counts."""
    p = dict(jax.tree.map(lambda a: a[0], params["stacks"][stack][sub]["rec"]))
    for n in ("conv_b", "b_a", "b_x"):
        p[n] = p[n] + jnp.asarray(rng.normal(size=p[n].shape).astype(np.float32) * 0.3)
    return p


@pytest.mark.parametrize("mode,S", [("train", 24), ("prefill", 24), ("prefill", 2),
                                    ("decode", 1)])
def test_rec_mixer_matches_reference(shared, mode, S):
    jcfg, cfg, params, _, _ = shared
    r = np.random.default_rng(S)
    p = _mixer_params(params, r)
    w = cfg.resolved_lru_width
    x = r.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    cache = None
    if mode == "decode":
        cache = {"conv": r.normal(size=(2, cfg.ssm_conv - 1, w)).astype(np.float32),
                 "lru": r.normal(size=(2, w)).astype(np.float32)}
    want, want_cache = jax_apply_rec(
        jcfg, p, jnp.asarray(x), mode=mode,
        cache=None if cache is None else {k: jnp.asarray(v) for k, v in cache.items()})
    mixer = RecMixer(cfg, {k: torch.tensor(np.asarray(v)) for k, v in p.items()})
    tcache = None if cache is None else {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, got_cache = mixer(torch.from_numpy(x), mode=mode, cache=tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    if mode == "train":
        assert got_cache is None
        return
    if mode == "decode":
        assert got_cache is tcache               # the state is updated in place
    assert set(got_cache) == set(want_cache) == {"conv", "lru"}
    for k in want_cache:
        assert tuple(got_cache[k].shape) == want_cache[k].shape
        np.testing.assert_allclose(got_cache[k].numpy(), np.asarray(want_cache[k]), **LAYER_TOL)


def test_geglu_mlp_matches_reference_with_tanh_gelu(shared):
    """jax.nn.gelu defaults to the tanh approximation; torch's default erf
    form would differ by ~1e-4 here."""
    jcfg, cfg, params, _, _ = shared
    p = jax.tree.map(lambda a: a[0], params["stacks"]["tail"]["blk"]["mlp"])
    x = np.random.default_rng(4).normal(size=(2, 7, cfg.d_model)).astype(np.float32) * 3
    want = np.asarray(jax_apply_mlp(jcfg, p, jnp.asarray(x)))
    mlp = MLP(*(torch.tensor(np.asarray(p[n])) for n in ("w_gate", "w_up", "w_down")),
              act="geglu")
    np.testing.assert_allclose(mlp(torch.from_numpy(x)).numpy(), want, **LAYER_TOL)
    erf = MLP(*(torch.tensor(np.asarray(p[n])) for n in ("w_gate", "w_up", "w_down")))
    erf.act = torch.nn.functional.gelu
    assert np.abs(erf(torch.from_numpy(x)).numpy() - want).max() > 1e-4


def test_forward_logits_matches_reference(shared):
    jcfg, cfg, params, model, _ = shared
    tokens = _tokens(cfg, 2, 40, 1)
    want = jax_forward_logits(jcfg, params, {"tokens": jnp.asarray(tokens)})
    got = forward_logits(cfg, model, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_forward_logits_matches_reference_through_pallas_interpret(shared, monkeypatch):
    """S = 256 and local_window=128 (as test_model_level_pallas_parity), so
    the reference's model reaches its Pallas scan and attention kernels and
    the window bites."""
    _, _, params, _, flat = shared
    jcfg, cfg = _configs(local_window=128)
    model = load_jax_params(cfg, flat, device="cpu")
    tokens = (np.arange(2 * 256, dtype=np.int32).reshape(2, 256) * 7919) % cfg.vocab_size
    monkeypatch.setenv("REPRO_USE_PALLAS", "interpret")
    want = jax_forward_logits(jcfg, params, {"tokens": jnp.asarray(tokens)})
    monkeypatch.delenv("REPRO_USE_PALLAS")
    got = forward_logits(cfg, model, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_cuts_and_split_forward_equal_full(shared):
    jcfg, cfg, _, model, _ = shared
    assert cut_points(cfg) == jax_cut_points(jcfg) == [
        ("period", 1), ("tail", 0), ("tail", 1), ("tail", 2)]
    full_j, full = jax_get_config(ARCH), get_config(ARCH)
    for layer, want in ((1, ("period", 1)), (13, ("period", 4)), (26, ("tail", 2))):
        assert cut_for_layer(full, layer) == jax_cut_for_layer(full_j, layer) == want
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 2, 24, 2)).long()}
    logits = forward_logits(cfg, model, batch)
    for cut in cut_points(cfg):
        torch.testing.assert_close(split_forward(cfg, model, batch, cut), logits,
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("version", ["bf16", "w8", "w4"])
def test_split_serving_matches_reference_engine(shared, version):
    jcfg, cfg, params, model, _ = shared
    tokens = _tokens(cfg, 2, 24, 3)
    jeng = JaxSplitServingEngine(jcfg, params, (version,))
    eng = SplitServingEngine(cfg, model, (version,), device="cpu")
    for cut in cut_points(cfg):
        want, want_bytes = jeng.infer({"tokens": jnp.asarray(tokens)}, cut, version)
        got, got_bytes = eng.infer({"tokens": tokens}, cut, version)
        assert got_bytes == want_bytes
        if version == "w8":
            diff = np.abs(got.numpy() - np.asarray(want))
            assert diff.max() <= W8_MAX and diff.mean() <= W8_MEAN, (cut, diff.max(), diff.mean())
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("version", ["w8", "w4"])
def test_quantize_tree_quantizes_only_the_dense_weights(shared, version):
    """The attention and MLP projections become QTensors, as in the
    reference's tree; the RG-LRU mixer's projections stay float tensors
    shared with the float model, and the tied head is no Dense leaf."""
    _, cfg, params, model, _ = shared
    qmodel = build_version_params(cfg, model, (version,))[version]
    quantized = set()
    for name, m in qmodel.named_modules():
        if isinstance(m, Dense):
            assert name.rsplit(".", 1)[1] in DENSE_WEIGHTS, name
            assert isinstance(m.w, QTensor) and m.w.bits == (8 if version == "w8" else 4)
            stacks, stack, _, sub, path = name.split(".", 4)
            quantized.add(f"{stacks}/{stack}/{sub}/{path.replace('.', '/')}")
    jtree = jax_quantize_tree(params, "w8a8" if version == "w8" else "w4")
    want = {"/".join(str(k.key) for k in kp) for kp, leaf in
            jax.tree_util.tree_flatten_with_path(
                jtree, is_leaf=lambda x: isinstance(x, JaxQTensor))[0]
            if isinstance(leaf, JaxQTensor)}
    assert quantized == want
    assert len(want) == 3 * 2 + 7 + 3              # s0, s1 MLPs; s2 attn + MLP; tail MLP
    mixer, qmixer = model.stacks["period"][0].s0.rec, qmodel.stacks["period"][0].s0.rec
    for n in ("w_gate_branch", "w_rec_branch", "w_a", "w_x", "w_out"):
        assert getattr(qmixer, n) is getattr(mixer, n)
    assert all(isinstance(m.w, torch.Tensor) for m in model.modules() if isinstance(m, Dense))


def _leaves(cache):
    return flatten({s: {b: {n: t.numpy() for n, t in d.items()} for b, d in x.items()}
                    for s, x in cache.items()})


def _prefill_and_decode(jcfg, cfg, params, model, tokens, total_len, n_steps):
    """Prefill, then ``n_steps`` decode steps fed the same tokens in both
    packages; asserts logits and every cache leaf agree at every step."""
    want, jcache = jax_prefill(jcfg, params, {"tokens": jnp.asarray(tokens)},
                               total_len=total_len)
    got, cache = prefill(cfg, model, {"tokens": torch.from_numpy(tokens).long()},
                         total_len=total_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    jflat, flat = flatten(jax.tree.map(np.asarray, jcache)), _leaves(cache)
    assert set(flat) == set(jflat) == {
        f"{s}/{n}" for s in ("period/s0", "period/s1", "tail/blk") for n in ("conv", "lru")
    } | {"period/s2/k", "period/s2/v"}
    for key in jflat:
        assert flat[key].shape == jflat[key].shape, key
        np.testing.assert_allclose(flat[key], jflat[key], **CACHE_TOL)
    r = np.random.default_rng(7)
    pos = tokens.shape[1]
    for _ in range(n_steps):
        tok = r.integers(0, cfg.vocab_size, tokens.shape[0]).astype(np.int32)
        want, jcache = jax_decode_step(jcfg, params, jcache, jnp.asarray(tok), jnp.int32(pos))
        got, cache = decode_step(cfg, model, cache, torch.from_numpy(tok).long(), pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
        jflat, flat = flatten(jax.tree.map(np.asarray, jcache)), _leaves(cache)
        for key in jflat:
            np.testing.assert_allclose(flat[key], jflat[key], **CACHE_TOL)
        pos += 1
    return cache


def test_prefill_and_decode_wrap_the_local_window_ring(shared):
    """A 96-token prompt past the 64-token window: the rings hold 64 slots,
    the prompt's last 64 positions rolled into place, and decode wraps them;
    the prefill's attention masks keys older than the window."""
    jcfg, cfg, params, model, _ = shared
    cache = _prefill_and_decode(jcfg, cfg, params, model, _tokens(cfg, 2, 96, 2),
                                total_len=104, n_steps=4)
    assert cache["period"]["s2"]["k"].shape == (1, 2, cfg.local_window, cfg.n_kv_heads,
                                                cfg.resolved_head_dim)


@pytest.mark.parametrize("S", [2, 12])     # S < K - 1 left-pads the conv tail
def test_prefill_cache_and_decode_steps_match_reference(shared, S):
    jcfg, cfg, params, model, _ = shared
    _prefill_and_decode(jcfg, cfg, params, model, _tokens(cfg, 2, S, S), total_len=20,
                        n_steps=3)


def test_decode_step_updates_every_leaf_in_place(shared):
    _, cfg, _, model, _ = shared
    tokens = torch.from_numpy(_tokens(cfg, 2, 6, 4)).long()
    _, cache = prefill(cfg, model, {"tokens": tokens}, total_len=10)
    kept = {k: torch.from_numpy(v.copy()) for k, v in _leaves(cache).items()}
    leaves = {f"{s}/{b}/{n}": t for s, x in cache.items() for b, d in x.items()
              for n, t in d.items()}
    _, out = decode_step(cfg, model, cache, tokens[:, -1], 6)
    assert out is cache
    for key, t in leaves.items():
        s, b, n = key.split("/")
        assert cache[s][b][n] is t and not torch.equal(t, kept[key]), key


def test_init_cache_and_cache_axes_match_reference(shared):
    jcfg, cfg, _, _, _ = shared
    for seq_len in (20, 100):                  # under and past the 64-token window
        want = jax_init_cache(jcfg, 3, seq_len)
        got = init_cache(cfg, 3, seq_len, device="cpu")
        wflat = flatten(jax.tree.map(np.asarray, want))
        assert set(wflat) == set(_leaves(got))
        for key, leaf in wflat.items():
            s, b, n = key.split("/")
            assert tuple(got[s][b][n].shape) == leaf.shape
            assert not got[s][b][n].any()
    assert cache_axes(cfg) == jax_cache_axes(jcfg)


def test_serving_engine_greedy_tokens_equal_reference(shared):
    """An 80-token prompt and 24 new tokens: decode runs past the window."""
    jcfg, cfg, params, model, _ = shared
    tokens = _tokens(cfg, 2, 80, 5)
    want = JaxServingEngine(jcfg, params, JaxServeConfig(max_new_tokens=24)).generate(
        {"tokens": jnp.asarray(tokens)})
    got = ServingEngine(cfg, model, ServeConfig(max_new_tokens=24), device="cpu").generate(
        {"tokens": tokens})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_continuous_batching_equals_reference(shared):
    """Mixed prompt lengths (left-padded cohorts), individual retirement,
    rings of 64 slots under a cache_len of 100 (cohorts decode past the
    window) and one request truncated by the cache_len: streams and
    ServerStats equal."""
    jcfg, cfg, params, model, _ = shared
    r = np.random.default_rng(6)
    specs = [(i, r.integers(0, cfg.vocab_size, int(r.integers(3, 70))).astype(np.int32),
              3 + i % 4) for i in range(6)] + [(6, np.arange(80, dtype=np.int32), 30)]
    jsrv = JaxServer(jcfg, params, max_batch=3, cache_len=100)
    srv = ContinuousBatchingServer(cfg, model, max_batch=3, cache_len=100, device="cpu")
    for rid, prompt, n_new in specs:
        jsrv.submit(JaxRequest(rid=rid, tokens=prompt, max_new_tokens=n_new))
        srv.submit(Request(rid=rid, tokens=prompt, max_new_tokens=n_new))
    jdone = sorted(jsrv.run(), key=lambda q: q.rid)
    done = sorted(srv.run(), key=lambda q: q.rid)
    assert [q.rid for q in done] == [q.rid for q in jdone] == list(range(7))
    for q, jq in zip(done, jdone):
        assert q.out == [int(t) for t in jq.out], q.rid
        assert q.truncated == jq.truncated
    assert done[6].truncated
    assert dataclasses.asdict(srv.stats) == dataclasses.asdict(jsrv.stats)
    assert srv.stats.slot_reclaims >= 1


def test_export_roundtrips_reference_params(shared):
    _, cfg, _, model, flat = shared
    out = export_params(model)
    assert list(out) == sorted(flat)
    for k in flat:
        assert out[k].dtype == flat[k].dtype, k
        np.testing.assert_array_equal(out[k], flat[k])


@pytest.mark.parametrize("full", [False, True])
def test_plan_matches_reference_leaf_by_leaf(full):
    """Keys in the reference's flattening order, shapes and dtypes; the full
    model has 2,894,574,080 parameters."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    if not full:
        jcfg, cfg = _configs()
    want = {"/".join(str(p.key) for p in kp): leaf for kp, leaf in
            jax.tree_util.tree_flatten_with_path(jax_abstract_params(jcfg))[0]}
    plan = plan_model(cfg)
    assert list(plan) == list(want)
    for k, p in plan.items():
        assert p.shape == want[k].shape, k
        assert (p.dtype or cfg.param_dtype) == str(want[k].dtype), k
    if full:
        assert sum(int(np.prod(p.shape)) for p in plan.values()) == FULL_PARAMS


def test_init_draws_the_reference_distributions_and_keeps_lam_f32(shared):
    """Deterministic leaves equal the reference's; lam puts a = exp(-8
    softplus(lam)) on U[0.9, 0.999]; lam stays f32 when the other leaves
    take param_dtype=bfloat16."""
    _, cfg, params, _, _ = shared
    model = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = params["stacks"]["period"]["s1"]["rec"]
    mixer = model.stacks["period"][0].s1.rec
    for n in ("conv_b", "b_a", "b_x"):
        np.testing.assert_array_equal(getattr(mixer, n).numpy(), np.asarray(ref[n][0]))
    w = cfg.resolved_lru_width
    a = torch.exp(-8 * torch.nn.functional.softplus(mixer.lam.double()))
    assert 0.9 - 1e-6 <= a.min() and a.max() <= 0.999 + 1e-6
    assert abs(a.mean().item() - 0.9495) < 0.01 and abs(a.std().item() - 0.0286) < 0.005
    assert abs(mixer.conv_w.std().item() - 0.1) < 0.01
    assert abs(mixer.w_a.std().item() - w ** -0.5) < 0.003
    assert abs(mixer.w_gate_branch.std().item() - cfg.d_model ** -0.5) < 0.003
    assert model.stacks["tail"][1].blk.mlp.w_gate.w.shape == (cfg.d_model, cfg.d_ff)
    bf = init(cfg.with_overrides(param_dtype="bfloat16"), torch.Generator().manual_seed(0),
              device="cpu").stacks["period"][0].s0.rec
    assert bf.w_a.dtype == torch.bfloat16 and bf.b_a.dtype == torch.bfloat16
    assert bf.lam.dtype == torch.float32


def test_embedding_is_scaled_by_sqrt_d_model_in_the_compute_dtype(shared):
    _, cfg, _, model, _ = shared
    tokens = torch.tensor([[3, 7]])
    want = model.tok_embed[tokens] * torch.tensor(cfg.d_model ** 0.5, dtype=torch.float32)
    torch.testing.assert_close(model.embed(tokens), want, rtol=0, atol=0)


def test_config_matches_reference():
    for reduced in (False, True):
        ref, port = jax_get_config(ARCH), get_config(ARCH)
        if reduced:
            ref, port = ref.reduced(), port.reduced()
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.resolved_lru_width == ref.resolved_lru_width
    cfg = get_config(ARCH)
    assert (cfg.block_pattern, cfg.local_window, cfg.resolved_head_dim) == (
        ("rec", "rec", "attn"), 2048, 256)


def test_serve_cli_runs_recurrentgemma_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--device", "cpu",
         "--batch", "2", "--prompt-len", "8", "--new-tokens", "4"],
        capture_output=True, text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("generated (2, 4) on cpu")
