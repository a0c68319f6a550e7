"""repro_torch's dense families qwen3-0.6b, starcoder2-3b and
phi3-medium-14b against repro on the CPU, at ``.reduced()`` sizes with
overrides that keep each family's features in view: qwen3 at head_dim 128
(``.reduced()`` sets 64, and then H * Dh = d_model), starcoder2 with a
window of 16 under 40-token prompts (the window masks, the rings wrap),
phi3 with its untied head; all three reduce to 4 query heads over 2 kv
heads, where h % HK and h // G differ.

The new layers (LayerNorm, the per-head q/k RMSNorm, the plain gelu MLP
with its biases, self-attention with qk_norm, QKV and o biases and
H * Dh != d_model), each family's logits, split serving at every cut in
bf16, w8 and w4 (the w8 bound against faulty w8 controls), prefill
caches and decode steps, greedy decode and the scheduler, quantization of
the dense projections only, the parameter plan, ``check_ported``, and a
fleet of the three dense archs under the controller (tables, ``simulate``
bit for bit, the execute backend's bytes).
Weights cross as a ``save_tree`` .npz file, their biases and norm leaves
drawn away from the init's zeros and ones so that those paths count."""
import dataclasses
import importlib
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
from repro.models.attention import apply_self_attn as jax_self_attn  # noqa: E402
from repro.models.layers import apply_mlp as jax_mlp  # noqa: E402
from repro.models.layers import apply_norm as jax_norm  # noqa: E402
from repro.models.layers import rms_norm_headwise as jax_rms_norm_headwise  # noqa: E402
from repro.models.model import abstract_params as jax_abstract_params  # noqa: E402
from repro.models.model import n_params as jax_n_params  # noqa: E402
from repro.policies import build_policy as ref_build_policy  # noqa: E402
from repro.quant.quantize import QTensor as JaxQTensor  # noqa: E402
from repro.quant.quantize import quantize_tree as jax_quantize_tree  # noqa: E402
from repro.scenarios import get_scenario as ref_get_scenario  # noqa: E402
from repro.serving import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving import SplitServingEngine as JaxSplitServingEngine  # noqa: E402
from repro.serving.scheduler import ContinuousBatchingServer as JaxServer  # noqa: E402
from repro.serving.scheduler import Request as JaxRequest  # noqa: E402
from repro.sim import ExecuteBackend as RefExecuteBackend  # noqa: E402
from repro.sim import FleetConfig as RefFleetConfig  # noqa: E402
from repro.sim import simulate as ref_simulate  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.checkpointing import flatten, load_tree  # noqa: E402
from repro_torch.configs import ALL_ARCHS, ModelConfig, get_config  # noqa: E402
from repro_torch.core.partition import (cut_activation_bytes, cut_points,  # noqa: E402
                                        split_forward)
from repro_torch.models import (decode_step, export_params, forward_logits,  # noqa: E402
                                load_jax_params, plan_model, prefill)
from repro_torch.models.attention import SelfAttention  # noqa: E402
from repro_torch.models.layers import MLP, Dense, LayerNorm, apply_norm  # noqa: E402
from repro_torch.models.model import check_ported  # noqa: E402
from repro_torch.policies import build_policy  # noqa: E402
from repro_torch.quant import QTensor, build_version_params  # noqa: E402
from repro_torch.quant.quantize import DENSE_WEIGHTS  # noqa: E402
from repro_torch.scenarios import get_scenario  # noqa: E402
from repro_torch.serving import (ContinuousBatchingServer, Request,  # noqa: E402
                                 ServeConfig, ServingEngine, SplitServingEngine)
from repro_torch.sim import ExecuteBackend, FleetConfig, simulate  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-0.6b", "starcoder2-3b", "phi3-medium-14b")
OVERRIDES = {"qwen3-0.6b": dict(head_dim=128), "starcoder2-3b": dict(sliding_window=16),
             "phi3-medium-14b": {}}
PROMPT = 40                      # past starcoder2's reduced window of 16
LAYER_TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=5e-4, atol=5e-4)
CACHE_TOL = dict(rtol=2e-5, atol=2e-5)
# w8: an f32 difference upstream of quantize_act (sums in another order)
# can flip one int8 code by one step (tests/test_torch_model.py). These
# models' logits are larger than reduced qwen2's: one embedding entry in two
# moved by one ulp, in the port alone, moves starcoder2's and phi3's w8
# logits by up to 0.047 and 0.052, past that file's 2e-2. So the gap to the
# reference is held against w8's own quantization error (the reference's w8
# against its bf16 logits), as chip_smoke.py holds card against CPU.
# Measured over the three archs x param seeds 0-3 x both cuts, as ratios to
# that error's max and mean:
#   the port against the reference                 max <= 0.54, mean <= 0.155
#   the port against itself, half the embedding
#   entries one ulp up                              max <= 0.64, mean <= 0.070
#   faulty w8 controls against the reference:
#   weight scales x 126/127                         max >= 0.41, mean >= 0.56
#   0.1 % of the weight codes moved one step        max >= 0.54, mean >= 0.68
# So the mean bound lies between sums in another order and a w8 fault; the
# max only bounds the gap.
W8_GAP_MAX, W8_GAP_MEAN = 1.0, 0.25
# the three dense archs of the mixed fleet, device i serving model i
FLEET_ARCHS = ("qwen2-0.5b", "qwen3-0.6b", "starcoder2-3b")
FLEET_SEQ, FLEET_REQUESTS = 8, 3000
BIASES = ("bq", "bk", "bv", "bo", "b_up", "b_down", "bias")
SCALES = ("scale", "q_norm", "k_norm")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the port's ops here are small, and one thread
    does not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch):
    kw = OVERRIDES[arch]
    return (jax_get_config(arch).reduced().with_overrides(**kw),
            get_config(arch).reduced().with_overrides(**kw))


def _visible(params, seed):
    """The reference's parameters with every bias and norm leaf moved off
    the init's zeros and ones."""
    r = np.random.default_rng(seed)

    def move(path, a):
        name = str(path[-1].key)
        if name in BIASES:
            return a + jnp.asarray(r.normal(0.0, 0.1, a.shape), a.dtype)
        if name in SCALES:
            return a * jnp.asarray(r.uniform(0.5, 1.5, a.shape), a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(move, params)


@dataclasses.dataclass
class Family:
    jcfg: object
    cfg: ModelConfig
    params: dict
    flat: dict
    model: object


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, cfg = _configs(arch)
            params = _visible(jax_init(jcfg, jax.random.key(0)), 1)
            path = str(tmp_path_factory.mktemp("npz") / f"{arch}.npz")
            jax_save_tree(path, params)
            flat, _ = load_tree(path)
            cache[arch] = Family(jcfg, cfg, params, flat,
                                 load_jax_params(cfg, flat, device="cpu"))
        return cache[arch]
    return get


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _layer0(params, group):
    return jax.tree.map(lambda a: a[0], params["stacks"]["main"]["blk"][group])


def _torch(p):
    return {k: torch.tensor(np.asarray(v)) for k, v in p.items()}


# --------------------------------------------------------------------------
# the new layers
# --------------------------------------------------------------------------

def test_layer_norm_matches_reference(families):
    f = families("starcoder2-3b")
    p = _layer0(f.params, "norm1")
    assert set(p) == {"scale", "bias"}
    x = np.random.default_rng(2).normal(3.0, 4.0, size=(2, 24, f.cfg.d_model)).astype(np.float32)
    want = jax_norm(f.jcfg, p, jnp.asarray(x))
    got = LayerNorm(*(torch.tensor(np.asarray(p[n])) for n in ("scale", "bias")))
    np.testing.assert_allclose(got(torch.from_numpy(x)).numpy(), np.asarray(want), **LAYER_TOL)


def test_headwise_rms_norm_matches_reference(families):
    f = families("qwen3-0.6b")
    scale = np.array(_layer0(f.params, "attn")["q_norm"])
    assert scale.shape == (128,)
    x = np.random.default_rng(3).normal(size=(2, 24, 4, 128)).astype(np.float32) * 3
    want = jax_rms_norm_headwise(jnp.asarray(x), jnp.asarray(scale))
    got = apply_norm(torch.from_numpy(x), torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_gelu_mlp_with_biases_matches_reference(families):
    f = families("starcoder2-3b")
    p = _layer0(f.params, "mlp")
    assert set(p) == {"w_up", "w_down", "b_up", "b_down"}
    x = np.random.default_rng(4).normal(size=(2, 24, f.cfg.d_model)).astype(np.float32)
    want = jax_mlp(f.jcfg, p, jnp.asarray(x))
    t = _torch(p)
    got = MLP(None, t["w_up"], t["w_down"], act="gelu", b_up=t["b_up"], b_down=t["b_down"])
    np.testing.assert_allclose(got(torch.from_numpy(x)).numpy(), np.asarray(want), **LAYER_TOL)
    with pytest.raises(ValueError, match="takes no w_gate"):
        MLP(t["w_up"], t["w_up"], t["w_down"], act="gelu")


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_self_attention_matches_reference(families, arch, window):
    """qwen3: qk_norm with H * Dh = 512 against d_model 256; starcoder2:
    QKV and o biases; phi3: neither."""
    f = families(arch)
    p = _layer0(f.params, "attn")
    want_leaves = {"wq", "wk", "wv", "wo"} | {
        "qwen3-0.6b": {"q_norm", "k_norm"}, "starcoder2-3b": {"bq", "bk", "bv", "bo"},
        "phi3-medium-14b": set()}[arch]
    assert set(p) == want_leaves
    H, Dh = f.cfg.n_heads, f.cfg.resolved_head_dim
    assert (H * Dh != f.cfg.d_model) == (arch == "qwen3-0.6b")
    x = np.random.default_rng(5).normal(size=(2, PROMPT, f.cfg.d_model)).astype(np.float32)
    want, _ = jax_self_attn(f.jcfg, p, jnp.asarray(x), pos0=jnp.int32(0), mode="train",
                            window=window)
    got, cache = SelfAttention(f.cfg, _torch(p), window=window)(torch.from_numpy(x))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


# --------------------------------------------------------------------------
# each family: logits, split serving, decode, the scheduler
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(families, arch):
    f = families(arch)
    tokens = _tokens(f.cfg, 2, PROMPT, 6)
    want = jax_forward_logits(f.jcfg, f.params, {"tokens": jnp.asarray(tokens)})
    got = forward_logits(f.cfg, f.model, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    full = got
    for cut in cut_points(f.cfg):
        torch.testing.assert_close(split_forward(f.cfg, f.model,
                                                 {"tokens": torch.from_numpy(tokens).long()},
                                                 cut), full, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference_through_pallas_interpret(families, arch, monkeypatch):
    """S = 256, so the reference's model reaches its Pallas attention kernel
    (at head_dim 128 for qwen3; under the 16-token window for
    starcoder2)."""
    f = families(arch)
    tokens = (np.arange(2 * 256, dtype=np.int32).reshape(2, 256) * 7919) % f.cfg.vocab_size
    monkeypatch.setenv("REPRO_USE_PALLAS", "interpret")
    want = jax_forward_logits(f.jcfg, f.params, {"tokens": jnp.asarray(tokens)})
    monkeypatch.delenv("REPRO_USE_PALLAS")
    got = forward_logits(f.cfg, f.model, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("version", ["bf16", "w8", "w4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_split_serving_matches_reference_engine(families, arch, version):
    """Every cut; the bytes at the cut those of the d_model-wide activation
    (whatever H * Dh), plus w8's f32 row scales."""
    f = families(arch)
    tokens = _tokens(f.cfg, 2, PROMPT, 7)
    assert cut_points(f.cfg) == jax_cut_points(f.jcfg) == [("main", 1), ("main", 2)]
    jeng = JaxSplitServingEngine(f.jcfg, f.params, ("bf16", version))
    eng = SplitServingEngine(f.cfg, f.model, (version,), device="cpu")
    link = cut_activation_bytes(f.cfg, tokens.shape)
    assert link == 2 * PROMPT * f.cfg.d_model * 4
    for cut in cut_points(f.cfg):
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


W8_FAULTS = {
    "scales x 126/127": lambda qt: dataclasses.replace(qt, scale=qt.scale * (126.0 / 127.0)),
    # one step toward 0 (a 0 code to 1)
    "0.1 % of codes one step": lambda qt: dataclasses.replace(qt, q=torch.where(
        torch.rand(qt.q.shape, generator=torch.Generator().manual_seed(0)) < 1e-3,
        qt.q + torch.where(qt.q > 0, -1, 1).to(torch.int8), qt.q)),
}


@pytest.mark.parametrize("fault", list(W8_FAULTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_w8_gap_bound_refuses_a_faulty_w8(families, arch, fault, monkeypatch):
    """The controls behind W8_GAP_MEAN: a w8 version whose weight scales or
    codes are off lies past the bound that the port's w8 keeps."""
    f = families(arch)
    tokens = _tokens(f.cfg, 2, PROMPT, 7)
    cut = ("main", 2)
    jeng = JaxSplitServingEngine(f.jcfg, f.params, ("bf16", "w8"))
    want = np.asarray(jeng.infer({"tokens": jnp.asarray(tokens)}, cut, "w8")[0])
    qerr = np.abs(want - np.asarray(jeng.infer({"tokens": jnp.asarray(tokens)}, cut, "bf16")[0]))
    qmod = importlib.import_module("repro_torch.quant.quantize")
    clean = qmod.quantize
    monkeypatch.setattr(qmod, "quantize", lambda w, mode: W8_FAULTS[fault](clean(w, mode)))
    got, _ = SplitServingEngine(f.cfg, f.model, ("w8",), device="cpu").infer(
        {"tokens": tokens}, cut, "w8")
    gap = np.abs(got.numpy() - want).mean()
    assert gap > W8_GAP_MEAN * qerr.mean(), (gap, qerr.mean())


def _leaves(cache):
    return flatten({s: {b: {n: t.numpy() for n, t in d.items()} for b, d in x.items()}
                    for s, x in cache.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_decode_steps_match_reference(families, arch):
    """The rings hold k after its norm and RoPE: every ring leaf and the
    logits agree after the prefill and after each of 6 decode steps; for
    starcoder2 the 16-slot rings wrap."""
    f = families(arch)
    tokens = _tokens(f.cfg, 2, PROMPT, 8)
    total = PROMPT + 6
    want, jcache = jax_prefill(f.jcfg, f.params, {"tokens": jnp.asarray(tokens)},
                               total_len=total)
    got, cache = prefill(f.cfg, f.model, {"tokens": torch.from_numpy(tokens).long()},
                         total_len=total)
    C = 16 if arch == "starcoder2-3b" else total
    assert tuple(cache["main"]["blk"]["k"].shape) == (2, 2, C, f.cfg.n_kv_heads,
                                                      f.cfg.resolved_head_dim)
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
        tok = r.integers(0, f.cfg.vocab_size, 2).astype(np.int32)
        want, jcache = jax_decode_step(f.jcfg, f.params, jcache, jnp.asarray(tok), jnp.int32(pos))
        got, cache = decode_step(f.cfg, f.model, cache, torch.from_numpy(tok).long(), pos)
        pos += 1


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_engine_greedy_tokens_equal_reference(families, arch):
    f = families(arch)
    tokens = _tokens(f.cfg, 2, PROMPT, 10)
    want = JaxServingEngine(f.jcfg, f.params, JaxServeConfig(max_new_tokens=12)).generate(
        {"tokens": jnp.asarray(tokens)})
    got = ServingEngine(f.cfg, f.model, ServeConfig(max_new_tokens=12), device="cpu").generate(
        {"tokens": tokens})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_continuous_batching_equals_reference(families):
    """starcoder2: mixed prompt lengths (left-padded cohorts) under rings of
    16 slots that the cohorts decode past, individual retirement: streams
    and ServerStats equal."""
    f = families("starcoder2-3b")
    r = np.random.default_rng(11)
    specs = [(i, r.integers(0, f.cfg.vocab_size, int(r.integers(3, 30))).astype(np.int32),
              3 + i % 4) for i in range(5)]
    jsrv = JaxServer(f.jcfg, f.params, max_batch=3, cache_len=48)
    srv = ContinuousBatchingServer(f.cfg, f.model, max_batch=3, cache_len=48, device="cpu")
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
# weights: quantization, the plan, weight exchange
# --------------------------------------------------------------------------

@pytest.mark.parametrize("version", ["w8", "w4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_tree_quantizes_only_the_dense_weights(families, arch, version):
    """The projections (and an untied head) become QTensors, as in the
    reference's tree; biases, norm scales and q/k norms stay the float
    model's f32 tensors."""
    f = families(arch)
    qmodel = build_version_params(f.cfg, f.model, (version,))[version]
    quantized = set()
    for name, m in qmodel.named_modules():
        if isinstance(m, Dense):
            assert name.rsplit(".", 1)[-1] in DENSE_WEIGHTS, name
            assert isinstance(m.w, QTensor) and m.w.bits == (8 if version == "w8" else 4)
            if name == "lm_head":
                quantized.add(name)
                continue
            stacks, stack, _, sub, path = name.split(".", 4)
            quantized.add(f"{stacks}/{stack}/{sub}/{path.replace('.', '/')}")
    jtree = jax_quantize_tree(f.params, "w8a8" if version == "w8" else "w4")
    want = {"/".join(str(k.key) for k in kp) for kp, leaf in
            jax.tree_util.tree_flatten_with_path(
                jtree, is_leaf=lambda x: isinstance(x, JaxQTensor))[0]
            if isinstance(leaf, JaxQTensor)}
    assert quantized == want
    gated = f.cfg.mlp_act != "gelu"
    assert len(want) == 4 + 2 + gated + (not f.cfg.tie_embeddings)
    float_params = dict(f.model.named_parameters())
    for name, t in qmodel.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        assert leaf in BIASES + SCALES + ("tok_embed",), name
        assert t is float_params[name] and t.dtype == torch.float32, name


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_matches_reference_leaf_by_leaf(arch, full):
    """Keys in the reference's flattening order, shapes and dtypes, and the
    full model's parameter count."""
    jcfg, cfg = (jax_get_config(arch), get_config(arch)) if full else _configs(arch)
    want = {"/".join(str(p.key) for p in kp): leaf for kp, leaf in
            jax.tree_util.tree_flatten_with_path(jax_abstract_params(jcfg))[0]}
    plan = plan_model(cfg)
    assert list(plan) == list(want)
    for k, p in plan.items():
        assert p.shape == want[k].shape, k
        assert (p.dtype or cfg.param_dtype) == str(want[k].dtype), k
    assert sum(int(np.prod(p.shape)) for p in plan.values()) == jax_n_params(jcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_export_roundtrips_reference_params(families, arch):
    f = families(arch)
    out = export_params(f.model)
    assert list(out) == sorted(f.flat)
    for k in f.flat:
        assert out[k].dtype == f.flat[k].dtype, k
        np.testing.assert_array_equal(out[k], f.flat[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference_and_reaches_the_clis(arch):
    for reduced in (False, True):
        ref, port = jax_get_config(arch), get_config(arch)
        if reduced:
            ref, port = ref.reduced(), port.reduced()
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert arch in ALL_ARCHS
    from repro_torch.launch import serve, split_serving
    for cli in (serve, split_serving):
        with pytest.raises(SystemExit) as e:      # argparse's --help
            cli.main(["--help"])
        assert e.value.code == 0


def test_check_ported_accepts_the_dense_families_and_refuses_the_rest():
    """Every arch runs in the port (the cross-attention families since they
    were ported); a cross-attention family without its flag is refused,
    naming the family."""
    for arch in ARCHS + ("mixtral-8x22b", "deepseek-v2-lite-16b", "llama-3.2-vision-90b",
                         "whisper-large-v3"):
        check_ported(get_config(arch))
    for arch, name, off in (("llama-3.2-vision-90b", "vlm", dict(cross_attn_every=0)),
                            ("whisper-large-v3", "audio", dict(enc_dec=False))):
        cfg = ModelConfig(**{**dataclasses.asdict(jax_get_config(arch)), **off})
        with pytest.raises(NotImplementedError, match=name):
            check_ported(cfg)


def test_serve_cli_runs_qwen3_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen3-0.6b", "--device",
         "cpu", "--batch", "2", "--prompt-len", "8", "--new-tokens", "4"],
        capture_output=True, text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines()[0].startswith("generated (2, 4) on cpu")


# --------------------------------------------------------------------------
# a fleet of mixed dense models under the controller
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet():
    """The tpu-execute preset's world with three devices, device i serving
    FLEET_ARCHS[i] at reduced size, in both packages."""
    ref_sc, sc = ref_get_scenario("tpu-execute"), get_scenario("tpu-execute")
    kw = dict(weights=sc.weights, reduced=True, seq_len=FLEET_SEQ,
              slot_seconds=sc.slot_seconds, peak_rps=sc.peak_rps)
    ref_env = R.make_tpu_env(list(FLEET_ARCHS), **kw)
    env = T.make_tpu_env(list(FLEET_ARCHS), device="cpu", **kw)
    return ref_sc, sc, ref_env, env, np.arange(len(FLEET_ARCHS), dtype=np.int32)


def test_mixed_fleet_tables_equal_reference(fleet):
    _, _, (ref_cfg, ref_tables), (cfg, tables), _ = fleet
    for fld in dataclasses.fields(ref_tables):
        a, b = getattr(ref_tables, fld.name), getattr(tables, fld.name)
        if hasattr(a, "shape"):
            assert b.dtype == torch.float32, fld.name
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=fld.name)
        else:
            assert a == b, fld.name
    assert tables.n_models == 3 and cfg.n_uavs == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_scenario_takes_the_new_archs(arch):
    """``Scenario.arch`` names a family: the tpu-execute world over it, its
    tables equal to the reference's scenario's, and its backend an
    ExecuteBackend over the family's reduced model."""
    ref = ref_get_scenario("tpu-execute").replace(arch=arch).build_env()
    cfg, tables, mids, backend = get_scenario("tpu-execute").replace(arch=arch).build_env(
        device="cpu")
    np.testing.assert_array_equal(mids, ref[2])
    assert tables.names == ref[1].names
    for fld in ("head_flops", "tail_flops", "cut_bytes", "tail_weight_bytes", "acc"):
        np.testing.assert_array_equal(getattr(tables, fld).numpy(),
                                      np.asarray(getattr(ref[1], fld)), err_msg=fld)
    assert isinstance(backend(), ExecuteBackend)


@pytest.mark.parametrize("engine", ["loop", "vectorized"])
@pytest.mark.parametrize("policy", ["device_only", "full_offload", "greedy_oracle"])
def test_mixed_fleet_simulate_equals_reference(fleet, policy, engine):
    ref_sc, sc, ref_env, env, mids = fleet
    kw = dict(n_requests=FLEET_REQUESTS, seed=sc.seeds[0], model_ids=mids)
    a = ref_simulate(*ref_env, ref_build_policy(policy, *ref_env), ref_sc.build_trace(),
                     fleet=RefFleetConfig(slo_s=sc.slo_s, engine=engine), **kw)
    b = simulate(*env, build_policy(policy, *env), sc.build_trace(),
                 fleet=FleetConfig(slo_s=sc.slo_s, engine=engine), **kw)
    assert a.epochs > 5 and b.summary == a.summary
    np.testing.assert_array_equal(b.selection_hist, a.selection_hist)
    ca, cb = a.epoch_log.columns, b.epoch_log.columns
    assert set(cb) == set(ca)
    for k in ca:
        np.testing.assert_array_equal(cb[k], ca[k], err_msg=k)
    for attr in ("latencies_s", "energies_j", "devices"):
        np.testing.assert_array_equal(getattr(b.metrics, attr), getattr(a.metrics, attr))
    # every model of the fleet is priced: the devices' selections differ
    assert b.selection_hist.shape[0] == 3


def test_mixed_fleet_execute_backend_bytes_exact(fleet, tmp_path):
    """greedy_oracle over the three devices with ``ExecuteBackend`` over
    three engines (the reference's reduced weights carried across as .npz):
    the backend's expected bytes equal the reference backend's for every
    (model, version, cut), every sampled request's bytes at the cut equal
    its own model's table entry, every model serves samples, and each
    SimResult equals the analytical run's."""
    ref_sc, sc, ref_env, env, mids = fleet
    cfgs, profs, engines, ref_cfgs, ref_params = [], [], [], [], []
    for i, arch in enumerate(FLEET_ARCHS):
        jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
        params = jax_init(jcfg, jax.random.key(i))
        path = jax_save_tree(str(tmp_path / f"{arch}.npz"), params)
        model = load_jax_params(cfg, load_tree(path)[0], device="cpu")
        prof = T.transformer_profile(cfg, seq_len=FLEET_SEQ)
        cfgs.append(cfg), profs.append(prof), ref_cfgs.append(jcfg), ref_params.append(params)
        engines.append(SplitServingEngine(cfg, model, tuple(v.version for v in prof.versions),
                                          device="cpu"))
    be = ExecuteBackend(*env, cfgs, profs, engines, seq_len=FLEET_SEQ, sample=24)
    ref_be = RefExecuteBackend(*ref_env, ref_cfgs,
                               [R.transformer_profile(c, seq_len=FLEET_SEQ) for c in ref_cfgs],
                               ref_params, seq_len=FLEET_SEQ, sample=0)
    tables = env[1]
    for m in range(3):
        for j in range(tables.n_versions):
            for k in range(tables.n_cuts):
                assert be.expected_act_bytes(m, j, k) == ref_be.expected_act_bytes(m, j, k)
    models = set()
    for rot in range(3):
        # an epoch executes its first device's request: rotate the devices'
        # models so that each model takes that turn
        kw = dict(n_requests=FLEET_REQUESTS, seed=sc.seeds[0], model_ids=np.roll(mids, -rot),
                  fleet=FleetConfig(slo_s=sc.slo_s))
        be.records.clear()
        res = simulate(*env, build_policy("greedy_oracle", *env), sc.build_trace(), backend=be,
                       **kw)
        plain = simulate(*env, build_policy("greedy_oracle", *env), sc.build_trace(), **kw)
        assert res.summary == plain.summary
        cc = res.cross_check
        assert cc["samples"] > 0 and cc["bytes_exact"], cc["records"]
        assert all(r["logits_finite"] for r in cc["records"])
        for r in cc["records"]:
            d = cfgs[[c.name for c in cfgs].index(r["model"])].d_model
            assert r["measured_bytes"] == FLEET_SEQ * (d + 4 if r["version"] == "w8" else 4 * d), r
            models.add(r["model"])
    assert models == {c.name for c in cfgs}
