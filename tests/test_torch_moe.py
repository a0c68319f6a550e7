"""repro_torch's mixture of experts (models/moe.py) and mixtral-8x22b
against repro on the CPU.

The router (``_route``: top-k, renormalised probabilities, each (token,
slot)'s place in its expert's buffer, the capacity drop, the Switch aux
loss), ``apply_moe`` through both dispatches (one chunk, several chunks,
the fallback to one chunk, dropping and non-dropping capacity, shared
experts), mixtral at ``.reduced()`` (whose capacity never drops) and at
capacity 1.25 with 32-token chunks (which drops: 8-token chunks would not,
since the capacity rounds up to 8 places, a whole chunk at 4 experts):
logits, also through the Pallas interpreter, split serving at every cut
in bf16, w8 and w4, prefill caches and decode steps, greedy decode, the
scheduler; the parameter plan (with a ``dense0`` stack), quantization that
leaves the ``moe`` module whole, the controller's tables and ``simulate``
with the execute backend over reduced mixtral, and the serve CLI.
Weights cross as a ``save_tree`` .npz file."""
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

import repro.core as R  # noqa: E402
from repro.checkpointing import save_tree as jax_save_tree  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.partition import cut_points as jax_cut_points  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward_logits as jax_forward_logits  # noqa: E402
from repro.models import init as jax_init  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models.model import abstract_params as jax_abstract_params  # noqa: E402
from repro.models.moe import _capacity as jax_capacity  # noqa: E402
from repro.models.moe import _route as jax_route  # noqa: E402
from repro.models.moe import apply_moe as jax_apply_moe  # noqa: E402
from repro.quant.quantize import QTensor as JaxQTensor  # noqa: E402
from repro.quant.quantize import quantize_tree as jax_quantize_tree  # noqa: E402
from repro.scenarios import get_scenario as ref_get_scenario  # noqa: E402
from repro.scenarios import run_scenario as ref_run_scenario  # noqa: E402
from repro.serving import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving import SplitServingEngine as JaxSplitServingEngine  # noqa: E402
from repro.serving.scheduler import ContinuousBatchingServer as JaxServer  # noqa: E402
from repro.serving.scheduler import Request as JaxRequest  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.checkpointing import flatten, load_tree  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.core.partition import cut_activation_bytes, cut_points, split_forward  # noqa: E402
from repro_torch.models import (decode_step, export_params, forward_logits,  # noqa: E402
                                load_jax_params, plan_model, prefill, stack_defs)
from repro_torch.models.layers import MLP, Dense  # noqa: E402
from repro_torch.models.moe import MoE, _capacity, _route  # noqa: E402
from repro_torch.quant import QTensor, build_version_params  # noqa: E402
from repro_torch.scenarios import get_scenario, run_scenario  # noqa: E402
from repro_torch.serving import (ContinuousBatchingServer, Request,  # noqa: E402
                                 ServeConfig, ServingEngine, SplitServingEngine)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "mixtral-8x22b"
# the reduced model as ``.reduced()`` gives it (non-dropping capacity), and
# at the published 1.25 in 32-token chunks, which drops
VARIANTS = {"reduced": {}, "capacity 1.25": dict(capacity_factor=1.25, moe_chunk=32)}
PROMPT = 64                      # two 32-token chunks of the dropping variant
MOE_TOL = dict(rtol=2e-5, atol=2e-5)
AUX_TOL = dict(rtol=1e-6, atol=1e-6)
MODEL_TOL = dict(rtol=5e-4, atol=5e-4)
CACHE_TOL = dict(rtol=2e-5, atol=2e-5)
# w8 against the reference, held against w8's own quantization error (the
# reference's w8 against its bf16 logits), as tests/test_torch_dense_families.py
# holds the dense families and for the same reason: an f32 difference
# upstream of quantize_act can flip one int8 code by a step
W8_GAP_MAX, W8_GAP_MEAN = 1.0, 0.25


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the port's ops here are small, and one thread
    does not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(**kw):
    return (jax_get_config(ARCH).reduced().with_overrides(**kw),
            get_config(ARCH).reduced().with_overrides(**kw))


# --------------------------------------------------------------------------
# the layer: routing and both dispatches
# --------------------------------------------------------------------------

def _moe_params(cfg, seed, shared=False):
    """The MoE's leaves as numpy, with the plan's shapes and scales."""
    r = np.random.default_rng(seed)
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts

    def w(*shape, scale=None):
        return (r.normal(size=shape) * (scale or shape[-2] ** -0.5)).astype(np.float32)
    p = {"router": w(d, E, scale=d ** -0.5), "w_gate": w(E, d, f), "w_up": w(E, d, f),
         "w_down": w(E, f, d)}
    if shared:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"w_gate": w(d, fs), "w_up": w(d, fs), "w_down": w(fs, d)}
    return p


def _x(B, S, d, seed):
    """Inputs that lean toward some experts (a shared offset), so that a
    capacity of 1.25 drops (token, slot) pairs."""
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, S, d)) + 1.5 * r.normal(size=(1, 1, d))).astype(np.float32)


def _port_moe(cfg, p):
    t = {k: torch.from_numpy(v) for k, v in p.items() if k != "shared"}
    shared = None
    if "shared" in p:
        s = {k: torch.from_numpy(v) for k, v in p["shared"].items()}
        shared = MLP(s["w_gate"], s["w_up"], s["w_down"], act=cfg.mlp_act)
    return MoE(cfg, t, shared=shared)


def test_capacity_matches_reference_at_mixtrals_widths():
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    for T_, C in ((1, 2), (512, 160), (1024, 320), (4608, 1440), (7, 8), (64, 24)):
        assert _capacity(T_, cfg) == jax_capacity(T_, jcfg)
        if T_ >= 64 or T_ == 1:
            assert _capacity(T_, cfg) == C


@pytest.mark.parametrize("T_", [1, 7, 32, 64])
def test_route_matches_reference(T_):
    """Experts, places and keep exactly; probabilities and aux within 1e-6;
    at 32 and 64 tokens the capacity of 1.25 drops pairs."""
    jcfg, cfg = _configs(capacity_factor=1.25)
    p = _moe_params(cfg, 0)
    x = _x(2, T_, cfg.d_model, T_)
    jp, je, jpos, jkeep, jsel, jaux = jax_route(jcfg, {"router": jnp.asarray(p["router"])},
                                                jnp.asarray(x))
    tp, te, pos, keep, sel, aux = _route(cfg, torch.from_numpy(p["router"]), torch.from_numpy(x))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **AUX_TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), **AUX_TOL)
    # slot 0 holds the top-1 expert; places count from 0 in token-major,
    # slot-minor order within each batch row
    assert bool((tp[..., 0] >= tp[..., 1]).all())
    assert (T_ >= 32) == (not bool(keep.all()))
    for b in range(2):
        order = te[b].reshape(-1)
        for e in range(cfg.n_experts):
            np.testing.assert_array_equal(pos[b].reshape(-1)[order == e].numpy(),
                                          np.arange(int((order == e).sum())))


# (B, S, overrides): one chunk; one chunk that drops; several chunks; several
# chunks that drop; S % chunk != 0 (the fallback to one chunk); shared experts
MOE_CASES = {
    "one chunk": (2, 16, {}),
    "one chunk, capacity 1.25": (2, 64, dict(capacity_factor=1.25)),
    "chunks of 8": (2, 32, dict(moe_chunk=8)),
    "chunks of 32, capacity 1.25": (2, 96, dict(moe_chunk=32, capacity_factor=1.25)),
    "S 20 over chunks of 8": (2, 20, dict(moe_chunk=8, capacity_factor=1.25)),
    "shared expert": (2, 32, dict(moe_chunk=16, n_shared_experts=1, capacity_factor=1.25)),
}


@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_apply_moe_matches_reference(case, impl):
    B, S, kw = MOE_CASES[case]
    jcfg, cfg = _configs(moe_impl=impl, **kw)
    p = _moe_params(cfg, 1, shared=bool(cfg.n_shared_experts))
    x = _x(B, S, cfg.d_model, 2)
    jy, jaux = jax_apply_moe(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    y, aux = _port_moe(cfg, p)(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MOE_TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), **AUX_TOL)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_einsum_dispatch_equals_gather_dispatch(case):
    """The port's two dispatches compute the same function."""
    B, S, kw = MOE_CASES[case]
    cfg = get_config(ARCH).reduced().with_overrides(**kw)
    p = _moe_params(cfg, 3, shared=bool(cfg.n_shared_experts))
    x = torch.from_numpy(_x(B, S, cfg.d_model, 4))
    ye, auxe = _port_moe(cfg, p)(x)
    yg, auxg = _port_moe(dataclasses.replace(cfg, moe_impl="gather"), p)(x)
    torch.testing.assert_close(ye, yg, **MOE_TOL)
    assert auxe.item() == auxg.item()


# --------------------------------------------------------------------------
# reduced mixtral: logits, split serving, decode, the scheduler
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Mixtral:
    jcfg: object
    cfg: object
    params: dict
    flat: dict
    model: object


@pytest.fixture(scope="module")
def mixtral(tmp_path_factory):
    cache = {}

    def get(variant):
        if variant not in cache:
            jcfg, cfg = _configs(**VARIANTS[variant])
            params = jax_init(jcfg, jax.random.key(0))
            path = str(tmp_path_factory.mktemp("npz") / "mixtral.npz")
            jax_save_tree(path, params)
            flat, _ = load_tree(path)
            cache[variant] = Mixtral(jcfg, cfg, params, flat,
                                     load_jax_params(cfg, flat, device="cpu"))
        return cache[variant]
    return get


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _first_layer_keep(m, tokens):
    """``keep`` of the first MoE layer's routing on ``tokens``, per chunk."""
    seen = []
    moe = m.model.stacks["main"][0].blk.moe
    hook = moe.register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
    try:
        forward_logits(m.cfg, m.model, {"tokens": torch.from_numpy(tokens).long()})
    finally:
        hook.remove()
    chunk = min(m.cfg.moe_chunk, tokens.shape[1])
    return torch.cat([_route(m.cfg, moe.router, xc)[3] for xc in seen[0].split(chunk, 1)], 1)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_logits_match_reference(mixtral, variant):
    """Logits within 5e-4 and split = full at every cut; the dropping
    variant really drops pairs in its first layer, the reduced one none."""
    m = mixtral(variant)
    tokens = _tokens(m.cfg, 2, PROMPT, 6)
    want = jax_forward_logits(m.jcfg, m.params, {"tokens": jnp.asarray(tokens)})
    got = forward_logits(m.cfg, m.model, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    for cut in cut_points(m.cfg):
        torch.testing.assert_close(split_forward(m.cfg, m.model,
                                                 {"tokens": torch.from_numpy(tokens).long()},
                                                 cut), got, rtol=2e-4, atol=2e-4)
    keep = _first_layer_keep(m, tokens)
    assert bool(keep.all()) == (variant == "reduced")


def test_forward_logits_match_reference_through_pallas_interpret(mixtral, monkeypatch):
    """S = 256, so the reference's model reaches its Pallas attention kernel
    (under the reduced 64-token window), with 32-token MoE chunks that
    drop."""
    m = mixtral("capacity 1.25")
    tokens = (np.arange(2 * 256, dtype=np.int32).reshape(2, 256) * 7919) % m.cfg.vocab_size
    monkeypatch.setenv("REPRO_USE_PALLAS", "interpret")
    want = jax_forward_logits(m.jcfg, m.params, {"tokens": jnp.asarray(tokens)})
    monkeypatch.delenv("REPRO_USE_PALLAS")
    got = forward_logits(m.cfg, m.model, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("version", ["bf16", "w8", "w4"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_split_serving_matches_reference_engine(mixtral, variant, version):
    m = mixtral(variant)
    tokens = _tokens(m.cfg, 2, PROMPT, 7)
    assert cut_points(m.cfg) == jax_cut_points(m.jcfg) == [("main", 1), ("main", 2)]
    jeng = JaxSplitServingEngine(m.jcfg, m.params, ("bf16", version))
    eng = SplitServingEngine(m.cfg, m.model, (version,), device="cpu")
    link = cut_activation_bytes(m.cfg, tokens.shape)
    for cut in cut_points(m.cfg):
        want, want_bytes = jeng.infer({"tokens": jnp.asarray(tokens)}, cut, version)
        got, got_bytes = eng.infer({"tokens": tokens}, cut, version)
        assert got_bytes == want_bytes == (link // 4 + 2 * PROMPT * 4 if version == "w8"
                                           else link)
        if version == "w8":
            diff = np.abs(got.numpy() - np.asarray(want))
            qerr = np.abs(np.asarray(want) - np.asarray(
                jeng.infer({"tokens": jnp.asarray(tokens)}, cut, "bf16")[0]))
            assert (diff.max() <= W8_GAP_MAX * qerr.max()
                    and diff.mean() <= W8_GAP_MEAN * qerr.mean()), (cut, diff.max(), diff.mean(),
                                                                    qerr.max(), qerr.mean())
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def _leaves(cache):
    return flatten({s: {b: {n: t.numpy() for n, t in d.items()} for b, d in x.items()}
                    for s, x in cache.items()})


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_cache_and_decode_steps_match_reference(mixtral, variant):
    """Rings and logits after the prefill (which drops in the capacity-1.25
    variant) and after each of 6 decode steps (C = 2 at one token: never
    drops); the 64-slot rings wrap."""
    m = mixtral(variant)
    tokens = _tokens(m.cfg, 2, PROMPT, 8)
    total = PROMPT + 6
    want, jcache = jax_prefill(m.jcfg, m.params, {"tokens": jnp.asarray(tokens)},
                               total_len=total)
    got, cache = prefill(m.cfg, m.model, {"tokens": torch.from_numpy(tokens).long()},
                         total_len=total)
    assert tuple(cache["main"]["blk"]["k"].shape) == (2, 2, m.cfg.sliding_window,
                                                      m.cfg.n_kv_heads, m.cfg.resolved_head_dim)
    r = np.random.default_rng(9)
    pos = PROMPT
    for step in range(7):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
        jflat, flat = flatten(jax.tree.map(np.asarray, jcache)), _leaves(cache)
        assert set(flat) == set(jflat) == {"main/blk/k", "main/blk/v"}
        for key in jflat:
            np.testing.assert_allclose(flat[key], jflat[key], **CACHE_TOL)
        if step == 6:
            break
        tok = r.integers(0, m.cfg.vocab_size, 2).astype(np.int32)
        want, jcache = jax_decode_step(m.jcfg, m.params, jcache, jnp.asarray(tok), jnp.int32(pos))
        got, cache = decode_step(m.cfg, m.model, cache, torch.from_numpy(tok).long(), pos)
        pos += 1


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_serving_engine_greedy_tokens_equal_reference(mixtral, variant):
    m = mixtral(variant)
    tokens = _tokens(m.cfg, 2, PROMPT, 10)
    want = JaxServingEngine(m.jcfg, m.params, JaxServeConfig(max_new_tokens=12)).generate(
        {"tokens": jnp.asarray(tokens)})
    got = ServingEngine(m.cfg, m.model, ServeConfig(max_new_tokens=12), device="cpu").generate(
        {"tokens": tokens})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_continuous_batching_equals_reference(mixtral):
    """Mixed prompt lengths in left-padded cohorts (the padding is routed
    and takes capacity, in both packages), individual retirement: streams
    and ServerStats equal."""
    m = mixtral("capacity 1.25")
    r = np.random.default_rng(11)
    specs = [(i, r.integers(0, m.cfg.vocab_size, int(r.integers(3, 40))).astype(np.int32),
              3 + i % 4) for i in range(5)]
    jsrv = JaxServer(m.jcfg, m.params, max_batch=3, cache_len=48)
    srv = ContinuousBatchingServer(m.cfg, m.model, max_batch=3, cache_len=48, device="cpu")
    for rid, prompt, n_new in specs:
        jsrv.submit(JaxRequest(rid=rid, tokens=prompt, max_new_tokens=n_new))
        srv.submit(Request(rid=rid, tokens=prompt, max_new_tokens=n_new))
    jdone = sorted(jsrv.run(), key=lambda q: q.rid)
    done = sorted(srv.run(), key=lambda q: q.rid)
    assert [q.rid for q in done] == [q.rid for q in jdone] == list(range(5))
    for q, jq in zip(done, jdone):
        assert q.out == [int(t) for t in jq.out], q.rid
    assert dataclasses.asdict(srv.stats) == dataclasses.asdict(jsrv.stats)


# --------------------------------------------------------------------------
# weights: the plan, export, quantization
# --------------------------------------------------------------------------

@pytest.mark.parametrize("overrides", [{}, dict(first_dense_layers=1),
                                       dict(first_dense_layers=1, n_shared_experts=1)])
def test_plan_matches_reference_leaf_by_leaf(overrides):
    """Keys in the reference's flattening order, shapes and dtypes; with
    ``first_dense_layers`` the ``dense0`` stack of dense layers."""
    jcfg, cfg = _configs(**overrides)
    want = {"/".join(str(p.key) for p in kp): leaf for kp, leaf in
            jax.tree_util.tree_flatten_with_path(jax_abstract_params(jcfg))[0]}
    plan = plan_model(cfg)
    assert list(plan) == list(want)
    for k, p in plan.items():
        assert p.shape == want[k].shape, k
        assert (p.dtype or cfg.param_dtype) == str(want[k].dtype), k
    names = [s.name for s in stack_defs(cfg)]
    assert names == (["dense0", "main"] if overrides else ["main"])
    assert ("stacks/dense0/blk/mlp/w_up" in plan) == bool(overrides)
    assert ("stacks/main/blk/moe/shared/w_up" in plan) == ("n_shared_experts" in overrides)


def test_full_plan_counts_mixtrals_parameters():
    """From the plan alone, nothing materialised: 140,630,071,296 at 56
    layers, 10,418,903,040 at the 4 that chip_smoke.py serves, 2,906,720,256
    at 1."""
    cfg = get_config(ARCH)
    assert ARCH in ALL_ARCHS
    for layers, want in ((56, 140_630_071_296), (4, 10_418_903_040), (1, 2_906_720_256)):
        plan = plan_model(cfg.with_overrides(n_layers=layers))
        assert sum(int(np.prod(p.shape)) for p in plan.values()) == want


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_export_roundtrips_reference_params(mixtral, variant):
    m = mixtral(variant)
    out = export_params(m.model)
    assert list(out) == sorted(m.flat)
    for k in m.flat:
        assert out[k].dtype == m.flat[k].dtype, k
        np.testing.assert_array_equal(out[k], m.flat[k])


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("version", ["w8", "w4"])
def test_quantize_tree_leaves_the_moe_whole(version, shared, tmp_path):
    """q, k, v, o and the untied head become QTensors, as in the
    reference's tree; the router, the experts and the shared experts' MLP
    stay the float model's f32 tensors."""
    jcfg, cfg = _configs(n_shared_experts=int(shared))
    params = jax_init(jcfg, jax.random.key(1))
    model = load_jax_params(cfg, load_tree(jax_save_tree(str(tmp_path / "m.npz"), params))[0],
                            device="cpu")
    qmodel = build_version_params(cfg, model, (version,))[version]
    quantized = set()
    for name, mod in qmodel.named_modules():
        if isinstance(mod, Dense) and isinstance(mod.w, QTensor):
            assert mod.w.bits == (8 if version == "w8" else 4)
            if name == "lm_head":
                quantized.add(name)
                continue
            stacks, stack, _, sub, path = name.split(".", 4)
            quantized.add(f"{stacks}/{stack}/{sub}/{path.replace('.', '/')}")
    jtree = jax_quantize_tree(params, "w8a8" if version == "w8" else "w4")
    want = {"/".join(str(k.key) for k in kp) for kp, leaf in
            jax.tree_util.tree_flatten_with_path(
                jtree, is_leaf=lambda x: isinstance(x, JaxQTensor))[0]
            if isinstance(leaf, JaxQTensor)}
    assert quantized == want == {f"stacks/main/blk/attn/{w}" for w in ("wq", "wk", "wv", "wo")} \
        | {"lm_head"}
    float_params = dict(model.named_parameters())
    moe_leaves = [n for n, _ in qmodel.named_parameters() if ".moe." in n]
    assert len(moe_leaves) == 2 * (4 + 3 * shared)      # two layers
    for name, t in qmodel.named_parameters():
        assert t is float_params[name] and t.dtype == torch.float32, name


# --------------------------------------------------------------------------
# the controller over mixtral, and the serve CLI
# --------------------------------------------------------------------------

def test_tpu_env_tables_equal_reference():
    ref_cfg, ref_tables = R.make_tpu_env([ARCH], reduced=True)
    cfg, tables = T.make_tpu_env([ARCH], reduced=True, device="cpu")
    for fld in dataclasses.fields(ref_tables):
        a, b = getattr(ref_tables, fld.name), getattr(tables, fld.name)
        if hasattr(a, "shape"):
            assert b.dtype == torch.float32, fld.name
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=fld.name)
        else:
            assert a == b, fld.name
    assert tables.names == (ARCH,) and cfg.n_uavs == ref_cfg.n_uavs


@pytest.mark.parametrize("policy", ["device_only", "full_offload", "greedy_oracle"])
def test_execute_over_mixtral_matches_reference(policy):
    """The tpu-execute preset over reduced mixtral: the same summary bit for
    bit, and the cross-check executes the same (version, cut) samples with
    every byte count exact."""
    ref_sc = ref_get_scenario("tpu-execute").replace(arch=ARCH, n_requests=1000)
    sc = get_scenario("tpu-execute").replace(arch=ARCH, n_requests=1000)
    ref = ref_run_scenario(ref_sc, (policy,))
    port = run_scenario(sc, (policy,), device="cpu")
    x, y = ref.results[policy], port.results[policy]
    assert y.per_seed == x.per_seed and y.mean == x.mean
    cx, cy = x.cross_check, y.cross_check
    if policy == "device_only":          # nothing crosses the link: nothing executes
        assert cx is None and cy is None
        return
    assert cy["bytes_exact"] and cx["bytes_exact"] and cy["samples"] == cx["samples"] > 0
    keys = ("version", "cut", "j", "k", "expected_bytes", "measured_bytes")
    assert [{k: r[k] for k in keys} for r in cy["records"]] \
        == [{k: r[k] for k in keys} for r in cx["records"]]
    assert all(r["logits_finite"] for r in cy["records"])


def test_serve_cli_runs_mixtral_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--device", "cpu",
         "--batch", "2", "--prompt-len", "8", "--new-tokens", "4"],
        capture_output=True, text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines()[0].startswith("generated (2, 4) on cpu")
