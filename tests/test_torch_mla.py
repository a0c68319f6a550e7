"""repro_torch's MLA attention (models/attention.MLAttention) and
deepseek-v2-lite-16b against repro on the CPU.

``flash_attention_ref`` with a v head dim apart from q's and k's (the
kernel's (192, 128) and (48, 32) instances) against the reference's Pallas
kernel in interpret mode; the MLA layer against ``_apply_mla`` in train,
prefill (output and both rings) and both decode forms past a full ring;
deepseek at ``.reduced()`` (non-dropping capacity) and at capacity 1.25
with 32-token MoE chunks (which drops): logits, also through the Pallas
interpreter, split serving at every cut in bf16, w8 and w4, prefill caches
and decode steps in the expanded and the absorbed form, greedy decode, the
scheduler; the parameter plan, quantization that leaves the latent's
leaves and the ``moe`` module whole, the controller's tables and
``simulate`` with the execute backend over reduced deepseek, and both CLIs.
Weights cross as a ``save_tree`` .npz file, the norm leaves drawn away from
the init's ones so that ``kv_norm`` counts."""
import dataclasses
import importlib.util
import json
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
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward_logits as jax_forward_logits  # noqa: E402
from repro.models import init as jax_init  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models.attention import _apply_mla as jax_apply_mla  # noqa: E402
from repro.models.model import abstract_params as jax_abstract_params  # noqa: E402
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
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import (cache_axes, decode_step, export_params,  # noqa: E402
                                forward_logits, init_cache, load_jax_params, plan_model,
                                prefill)
from repro_torch.models.attention import MLAttention  # noqa: E402
from repro_torch.models.layers import Dense  # noqa: E402
from repro_torch.models.moe import _route  # noqa: E402
from repro_torch.quant import QTensor, build_version_params  # noqa: E402
from repro_torch.scenarios import get_scenario, run_scenario  # noqa: E402
from repro_torch.serving import (ContinuousBatchingServer, Request,  # noqa: E402
                                 ServeConfig, ServingEngine, SplitServingEngine)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "deepseek-v2-lite-16b"
# the reduced model as ``.reduced()`` gives it (non-dropping capacity), and
# at the published 1.25 in 32-token chunks, which drops
VARIANTS = {"reduced": {}, "capacity 1.25": dict(capacity_factor=1.25, moe_chunk=32)}
PROMPT = 64                      # two 32-token chunks of the dropping variant
TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=5e-4, atol=5e-4)
# the reference's own bound between its absorbed and expanded decode
# (tests/test_partition_serving.py::test_mla_absorb_decode_parity)
ABSORB_TOL = dict(rtol=2e-4, atol=2e-4)
# w8 against the reference, held against w8's own quantization error (the
# reference's w8 against its bf16 logits), as tests/test_torch_dense_families.py
# holds the dense families and for the same reason: an f32 difference
# upstream of quantize_act can flip one int8 code by a step
W8_GAP_MAX, W8_GAP_MEAN = 1.0, 0.25
SCALES = ("scale", "kv_norm")


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


def _visible(params, seed):
    """The reference's parameters with every norm scale (kv_norm too) moved
    off the init's ones."""
    r = np.random.default_rng(seed)

    def move(path, a):
        if str(path[-1].key) in SCALES:
            return a * jnp.asarray(r.uniform(0.5, 1.5, a.shape), a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(move, params)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


# --------------------------------------------------------------------------
# flash_attention's plain version with Dv != D, against the Pallas kernel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("D,Dv", [(48, 32), (192, 128)])
@pytest.mark.parametrize("B,H,HK,S,causal,window", [
    (2, 4, 4, 40, True, None),     # MLA's H = HK, ragged S
    (1, 4, 2, 32, False, None),    # GQA, no mask
    (1, 4, 2, 40, True, 16),       # a window, h % HK != h // G
    (2, 2, 1, 24, True, None)])    # MQA
def test_flash_attention_ref_with_another_v_width_matches_pallas(B, H, HK, S, causal, window,
                                                                 D, Dv):
    r = np.random.default_rng(S + D)
    q, k, v = (r.normal(size=s).astype(np.float32)
               for s in ((B, H, S, D), (B, HK, S, D), (B, HK, S, Dv)))
    got = fa.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=causal, window=window)
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal, window=window,
                     interpret=True)
    assert tuple(got.shape) == (B, H, S, Dv) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (D, Dv) in fa.HEAD_DIMS


# --------------------------------------------------------------------------
# the MLA layer against _apply_mla
# --------------------------------------------------------------------------

def _mla_params(cfg, seed):
    """One MLA layer's leaves as numpy, with the plan's shapes and fan-in
    scales; kv_norm away from ones."""
    r = np.random.default_rng(seed)
    d, H = cfg.d_model, cfg.n_heads
    nope, rope, vd, R_ = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim,
                          cfg.kv_lora_rank)

    def w(*shape):
        return (r.normal(size=shape) * shape[0] ** -0.5).astype(np.float32)
    return {"wq": w(d, H * (nope + rope)), "w_dkv": w(d, R_ + rope),
            "kv_norm": r.uniform(0.5, 1.5, R_).astype(np.float32),
            "w_uk": w(R_, H * nope), "w_uv": w(R_, H * vd), "wo": w(H * vd, d)}


# (mode, window): a 24-token prompt into 16-slot rings, then one token at
# position 24 past the full ring
MLA_CASES = [("train", None), ("train", 16), ("prefill", None), ("decode expanded", None),
             ("decode absorbed", None), ("decode expanded", 8), ("decode absorbed", 8)]


@pytest.mark.parametrize("mode,window", MLA_CASES)
def test_mla_layer_matches_reference(mode, window):
    absorb = mode == "decode absorbed"
    jcfg, cfg = _configs(mla_absorb=absorb)
    p = _mla_params(cfg, 0)
    r = np.random.default_rng(1)
    x = r.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    layer = MLAttention(cfg, {k: torch.from_numpy(v) for k, v in p.items()}, window=window)
    if mode == "train":
        want, _ = jax_apply_mla(jcfg, jp, jnp.asarray(x), pos0=0, mode="train", cache=None,
                                window=window)
        got, cache = layer(torch.from_numpy(x), mode="train")
        assert cache is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    want, jcache = jax_apply_mla(jcfg, jp, jnp.asarray(x), pos0=0, mode="prefill", cache=None,
                                 window=window, cache_len=16)
    got, cache = layer(torch.from_numpy(x), mode="prefill", cache_len=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert {k: tuple(t.shape) for k, t in cache.items()} == {
        "ckv": (2, 16, cfg.kv_lora_rank), "krope": (2, 16, cfg.qk_rope_head_dim)}
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]), **TOL)
    if mode == "prefill":
        return
    x1 = r.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    want, jcache = jax_apply_mla(jcfg, jp, jnp.asarray(x1), pos0=24, mode="decode",
                                 cache=jcache, window=window)
    got, new = layer(torch.from_numpy(x1), pos0=24, mode="decode", cache=cache)
    assert new["ckv"] is cache["ckv"]                  # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(new[key].numpy(), np.asarray(jcache[key]), **TOL)


# --------------------------------------------------------------------------
# reduced deepseek: logits, split serving, decode, the scheduler
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DeepSeek:
    jcfg: object
    cfg: object
    params: dict
    flat: dict
    model: object


@pytest.fixture(scope="module")
def deepseek(tmp_path_factory):
    cache = {}

    def get(variant):
        if variant not in cache:
            jcfg, cfg = _configs(**VARIANTS[variant])
            params = _visible(jax_init(jcfg, jax.random.key(0)), 1)
            path = str(tmp_path_factory.mktemp("npz") / "deepseek.npz")
            jax_save_tree(path, params)
            flat, _ = load_tree(path)
            cache[variant] = DeepSeek(jcfg, cfg, params, flat,
                                      load_jax_params(cfg, flat, device="cpu"))
        return cache[variant]
    return get


def _first_moe_keep(m, tokens):
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
def test_forward_logits_match_reference(deepseek, variant):
    """Logits within 5e-4 and split = full at every cut; the dropping
    variant really drops pairs in its first MoE layer, the reduced one
    none."""
    m = deepseek(variant)
    tokens = _tokens(m.cfg, 2, PROMPT, 6)
    want = jax_forward_logits(m.jcfg, m.params, {"tokens": jnp.asarray(tokens)})
    got = forward_logits(m.cfg, m.model, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    assert cut_points(m.cfg) == jax_cut_points(m.jcfg) == [("dense0", 1), ("main", 0),
                                                          ("main", 1)]
    for cut in cut_points(m.cfg):
        torch.testing.assert_close(split_forward(m.cfg, m.model,
                                                 {"tokens": torch.from_numpy(tokens).long()},
                                                 cut), got, rtol=2e-4, atol=2e-4)
    keep = _first_moe_keep(m, tokens)
    assert bool(keep.all()) == (variant == "reduced")


def test_forward_logits_match_reference_through_pallas_interpret(deepseek, monkeypatch):
    """The reference's MLA reaches its Pallas attention kernel at (nope +
    rope, vd) = (48, 32), with 32-token MoE chunks that drop."""
    m = deepseek("capacity 1.25")
    tokens = _tokens(m.cfg, 2, PROMPT, 12)
    monkeypatch.setenv("REPRO_USE_PALLAS", "interpret")
    want = jax_forward_logits(m.jcfg, m.params, {"tokens": jnp.asarray(tokens)})
    monkeypatch.delenv("REPRO_USE_PALLAS")
    got = forward_logits(m.cfg, m.model, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("version", ["bf16", "w8", "w4"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_split_serving_matches_reference_engine(deepseek, variant, version):
    m = deepseek(variant)
    tokens = _tokens(m.cfg, 2, PROMPT, 7)
    jeng = JaxSplitServingEngine(m.jcfg, m.params, ("bf16", version))
    eng = SplitServingEngine(m.cfg, m.model, (version,), device="cpu")
    link = cut_activation_bytes(m.cfg, tokens.shape)
    assert link == 2 * PROMPT * m.cfg.d_model * 4
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


def _absorbing(model, on):
    """Every MLA layer of ``model`` set to the absorbed (``on``) or the
    expanded decode form."""
    for mod in model.modules():
        if isinstance(mod, MLAttention):
            mod.absorb = on


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_cache_and_decode_steps_match_reference(deepseek, variant, absorb):
    """Rings and logits after the prefill (which drops in the capacity-1.25
    variant) and after each of 6 decode steps in the expanded or the
    absorbed form; 48-slot rings under a 64-token prompt, so the prefill
    keeps the last 48 positions and the steps wrap."""
    m = deepseek(variant)
    jcfg = m.jcfg.with_overrides(mla_absorb=absorb)
    tokens = _tokens(m.cfg, 2, PROMPT, 8)
    want, jcache = jax_prefill(jcfg, m.params, {"tokens": jnp.asarray(tokens)}, total_len=48)
    got, cache = prefill(m.cfg, m.model, {"tokens": torch.from_numpy(tokens).long()},
                         total_len=48)
    assert tuple(cache["main"]["blk"]["ckv"].shape) == (1, 2, 48, m.cfg.kv_lora_rank)
    r = np.random.default_rng(9)
    pos = PROMPT
    _absorbing(m.model, absorb)
    try:
        for step in range(7):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
            jflat, flat = flatten(jax.tree.map(np.asarray, jcache)), _leaves(cache)
            assert set(flat) == set(jflat) == {f"{s}/blk/{n}" for s in ("dense0", "main")
                                               for n in ("ckv", "krope")}
            for key in jflat:
                np.testing.assert_allclose(flat[key], jflat[key], **TOL)
            if step == 6:
                break
            tok = r.integers(0, m.cfg.vocab_size, 2).astype(np.int32)
            want, jcache = jax_decode_step(jcfg, m.params, jcache, jnp.asarray(tok),
                                           jnp.int32(pos))
            got, cache = decode_step(m.cfg, m.model, cache, torch.from_numpy(tok).long(), pos)
            pos += 1
    finally:
        _absorbing(m.model, False)


def test_absorbed_decode_equals_expanded_decode(deepseek):
    """The reference's own check, on the port: both forms from clones of one
    prefill cache, within its 2e-4."""
    m = deepseek("reduced")
    tokens = _tokens(m.cfg, 2, 16, 13)
    _, cache = prefill(m.cfg, m.model, {"tokens": torch.from_numpy(tokens).long()})
    twin = {s: {b: {n: t.clone() for n, t in d.items()} for b, d in x.items()}
            for s, x in cache.items()}
    tok = torch.tensor([1, 2])
    base, _ = decode_step(m.cfg, m.model, cache, tok, 16)
    _absorbing(m.model, True)
    try:
        absorbed, _ = decode_step(m.cfg, m.model, twin, tok, 16)
    finally:
        _absorbing(m.model, False)
    torch.testing.assert_close(absorbed, base, **ABSORB_TOL)
    assert (absorbed - base).abs().max() > 0       # the two forms really ran


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_serving_engine_greedy_tokens_equal_reference(deepseek, variant):
    m = deepseek(variant)
    tokens = _tokens(m.cfg, 2, PROMPT, 10)
    want = JaxServingEngine(m.jcfg, m.params, JaxServeConfig(max_new_tokens=12)).generate(
        {"tokens": jnp.asarray(tokens)})
    got = ServingEngine(m.cfg, m.model, ServeConfig(max_new_tokens=12), device="cpu").generate(
        {"tokens": tokens})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_continuous_batching_equals_reference(deepseek, variant):
    """Mixed prompt lengths in left-padded cohorts, individual retirement
    (the scheduler gathers the MLA rings' slots through ``cache_axes``):
    streams and ServerStats equal."""
    m = deepseek(variant)
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


def test_cache_tree_and_axes_hold_the_latent():
    cfg = get_config(ARCH).reduced()
    cache = init_cache(cfg, 3, 20, device="cpu")
    assert {s: {n: tuple(t.shape) for n, t in x["blk"].items()} for s, x in cache.items()} == {
        s: {"ckv": (1, 3, 20, 64), "krope": (1, 3, 20, 16)} for s in ("dense0", "main")}
    assert cache_axes(cfg) == {s: {"blk": {"ckv": ("layers", "batch", "kv_cache_seq", None),
                                           "krope": ("layers", "batch", "kv_cache_seq", None)}}
                               for s in ("dense0", "main")}


# --------------------------------------------------------------------------
# weights: the plan, export, quantization
# --------------------------------------------------------------------------

def test_plan_matches_reference_leaf_by_leaf():
    """Keys in the reference's flattening order, shapes and dtypes: MLA's
    leaves in both stacks, no wk, wv or biases."""
    jcfg, cfg = _configs()
    want = {"/".join(str(p.key) for p in kp): leaf for kp, leaf in
            jax.tree_util.tree_flatten_with_path(jax_abstract_params(jcfg))[0]}
    plan = plan_model(cfg)
    assert list(plan) == list(want)
    for k, p in plan.items():
        assert p.shape == want[k].shape, k
        assert (p.dtype or cfg.param_dtype) == str(want[k].dtype), k
    for s in ("dense0", "main"):
        assert sorted(k.rsplit("/", 1)[1] for k in plan if k.startswith(f"stacks/{s}/blk/attn/")) \
            == ["kv_norm", "w_dkv", "w_uk", "w_uv", "wo", "wq"]
    assert plan["stacks/main/blk/attn/kv_norm"].init == "ones"


def test_full_plan_counts_deepseeks_parameters():
    """From the plan alone, nothing materialised: 15,647,895,040 at 27
    layers; 1,026,698,240 at the 2 that chip_smoke.py compares with the CPU."""
    cfg = get_config(ARCH)
    assert ARCH in ALL_ARCHS
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config(ARCH))
    for layers in (27, 2):
        plan = plan_model(cfg.with_overrides(n_layers=layers))
        n = sum(int(np.prod(p.shape)) for p in plan.values())
        want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(
            jax_abstract_params(jax_get_config(ARCH).with_overrides(n_layers=layers))))
        assert n == want == {27: 15_647_895_040, 2: 1_026_698_240}[layers]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_export_roundtrips_reference_params(deepseek, variant):
    m = deepseek(variant)
    out = export_params(m.model)
    assert list(out) == sorted(m.flat)
    for k in m.flat:
        assert out[k].dtype == m.flat[k].dtype, k
        np.testing.assert_array_equal(out[k], m.flat[k])


@pytest.mark.parametrize("version", ["w8", "w4"])
def test_quantize_tree_quantizes_the_references_leaves(deepseek, version):
    """wq and wo of both stacks, dense0's MLP and the untied head become
    QTensors, as in the reference's tree; w_dkv, w_uk, w_uv, kv_norm and
    the moe subtree stay the float model's f32 tensors."""
    m = deepseek("reduced")
    qmodel = build_version_params(m.cfg, m.model, (version,))[version]
    quantized = set()
    for name, mod in qmodel.named_modules():
        if isinstance(mod, Dense) and isinstance(mod.w, QTensor):
            assert mod.w.bits == (8 if version == "w8" else 4)
            if name == "lm_head":
                quantized.add(name)
                continue
            stacks, stack, _, sub, path = name.split(".", 4)
            quantized.add(f"{stacks}/{stack}/{sub}/{path.replace('.', '/')}")
    jtree = jax_quantize_tree(m.params, "w8a8" if version == "w8" else "w4")
    want = {"/".join(str(k.key) for k in kp) for kp, leaf in
            jax.tree_util.tree_flatten_with_path(
                jtree, is_leaf=lambda x: isinstance(x, JaxQTensor))[0]
            if isinstance(leaf, JaxQTensor)}
    assert quantized == want == (
        {f"stacks/{s}/blk/attn/{w}" for s in ("dense0", "main") for w in ("wq", "wo")}
        | {f"stacks/dense0/blk/mlp/{w}" for w in ("w_gate", "w_up", "w_down")} | {"lm_head"})
    float_params = dict(m.model.named_parameters())
    kept = [n for n, _ in qmodel.named_parameters()
            if n.rsplit(".", 1)[-1] in ("w_dkv", "w_uk", "w_uv", "kv_norm") or ".moe." in n]
    assert len(kept) == 2 * 4 + 4 + 3          # the latent's leaves, router, experts, shared
    for name, t in qmodel.named_parameters():
        assert t is float_params[name] and t.dtype == torch.float32, name


# --------------------------------------------------------------------------
# the controller over deepseek, and the CLIs
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
def test_execute_over_deepseek_matches_reference(policy):
    """The tpu-execute preset over reduced deepseek: the same summary bit
    for bit, and the cross-check executes the same (version, cut) samples
    with every byte count exact."""
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


def test_serve_cli_runs_deepseek_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--device", "cpu",
         "--batch", "2", "--prompt-len", "8", "--new-tokens", "4"],
        capture_output=True, text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines()[0].startswith("generated (2, 4) on cpu")


def test_simulate_cli_executes_deepseek_as_the_reference_script(tmp_path, monkeypatch):
    """``--env tpu --arch deepseek-v2-lite-16b --execute``, no --scenario:
    the port's JSON equals ``scripts/simulate.py``'s for the statics, the
    sampled requests executed through reduced deepseek on both sides."""
    from repro_torch.launch import simulate as cli
    spec = importlib.util.spec_from_file_location("ref_simulate", ROOT / "scripts/simulate.py")
    ref_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_cli)
    argv = ["--env", "tpu", "--arch", ARCH, "--execute", "--devices", "2", "--requests", "400",
            "--compare", "device_only,greedy_oracle", "--seeds", "0", "--quiet"]
    monkeypatch.setattr(sys, "argv", ["simulate.py", *argv, "--json", str(tmp_path / "ref.json")])
    ref_cli.main()
    report = cli.main(argv + ["--json", str(tmp_path / "port.json"), "--device", "cpu"])
    want = json.loads((tmp_path / "ref.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert list(got["policies"]) == ["device_only", "greedy_oracle"]
    # the cross-check's latency ratios divide measured wall times: no static
    for run in (want, got):
        for key in ("latency_ratio_median", "latency_ratio_max"):
            assert run["policies"]["greedy_oracle"]["cross_check"].pop(key) > 0
    assert {k: v for k, v in got.items() if k != "config"} \
        == {k: v for k, v in want.items() if k != "config"}
    assert got["config"] == {**want["config"], "device": "cpu"}
    cc = report.results["greedy_oracle"].cross_check
    assert cc["bytes_exact"] and cc["samples"] > 0
