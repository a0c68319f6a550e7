"""What tests/test_torch_vlm.py and tests/test_torch_audio.py share: the
cross-attention families (llama-3.2-vision-90b, whisper-large-v3) built in
both packages from one ``save_tree`` .npz file, with nonzero gates, biases
and norm parameters drawn from a seed, fed random media or frames made
with numpy; and the checks both families run the same way.

A zero gate (tanh(0) = 0) or zero media (k = v = 0 without a k or v bias)
would let a broken cross path match the reference, so nothing here uses
the reference's initial zeros, and each file's degeneracy guard shows the
cross path moves the logits."""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.checkpointing import save_tree as jax_save_tree
from repro.configs import get_config as jax_get_config
from repro.core.partition import cut_points as jax_cut_points
from repro.models import decode_step as jax_decode_step
from repro.models import forward_logits as jax_forward_logits
from repro.models import init as jax_init
from repro.models import prefill as jax_prefill
from repro.models.model import abstract_params as jax_abstract_params
from repro.models.model import cache_axes as jax_cache_axes
from repro.models.model import init_cache as jax_init_cache
from repro.quant.quantize import QTensor as JaxQTensor
from repro.quant.quantize import quantize_tree as jax_quantize_tree
from repro.scenarios import get_scenario as ref_get_scenario
from repro.scenarios import run_scenario as ref_run_scenario
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import SplitServingEngine as JaxSplitServingEngine
from repro.serving.scheduler import ContinuousBatchingServer as JaxServer
from repro.serving.scheduler import Request as JaxRequest

import repro_torch.core as T
from repro_torch.checkpointing import flatten, load_tree
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.partition import cut_activation_bytes, cut_points, split_forward
from repro_torch.models import (cache_axes, decode_step, export_params, forward_logits,
                                init_cache, load_jax_params, plan_model, prefill)
from repro_torch.models.layers import Dense
from repro_torch.quant import QTensor, build_version_params
from repro_torch.scenarios import get_scenario, run_scenario
from repro_torch.serving import (ContinuousBatchingServer, Request, ServeConfig,
                                 ServingEngine, SplitServingEngine)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=5e-4, atol=5e-4)
# w8 against the reference: the gap held within the reference's own w8
# error (its w8 against its bf16 logits), as the other families' files hold
# it; see check_w8_against_reference
W8_GAP_MAX = 1.0
# the degeneracy guard: with the cross path cut, the logits must move by
# more than this many times the model-level tolerance
GUARD = 100
PROMPT, NEW = 24, 4
NORM_SCALES = ("scale",)
BIASES = ("bq", "bk", "bv", "bo", "b_up", "b_down", "bias")
GATES = ("gate_attn", "gate_mlp")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the port's ops here are small, and one thread
    does not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def visible(params, seed):
    """The reference's parameters with every gate, bias and norm parameter
    drawn away from its init's zeros and ones: gates of either sign with
    |gate| in [0.5, 1.5], biases N(0, 0.1), norm scales in [0.5, 1.5]."""
    r = np.random.default_rng(seed)

    def move(path, a):
        name = str(path[-1].key)
        if name in GATES:
            return jnp.asarray(r.choice([-1.0, 1.0], a.shape) * r.uniform(0.5, 1.5, a.shape),
                               a.dtype)
        if name in BIASES:
            return jnp.asarray(r.normal(size=a.shape) * 0.1, a.dtype)
        if name in NORM_SCALES:
            return a * jnp.asarray(r.uniform(0.5, 1.5, a.shape), a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(move, params)


@dataclasses.dataclass
class Family:
    jcfg: object
    cfg: object
    params: dict
    flat: dict
    model: object


def build(arch, tmp_path, **overrides) -> Family:
    """``arch`` at ``.reduced()`` with ``overrides`` in both packages: the
    reference's init (seed 0) moved off its zeros and ones (seed 1), through
    a ``save_tree`` file into the port's model on the CPU."""
    jcfg = jax_get_config(arch).reduced().with_overrides(**overrides)
    cfg = get_config(arch).reduced().with_overrides(**overrides)
    params = visible(jax_init(jcfg, jax.random.key(0)), 1)
    path = str(tmp_path / "params.npz")
    jax_save_tree(path, params)
    flat, _ = load_tree(path)
    return Family(jcfg, cfg, params, flat, load_jax_params(cfg, flat, device="cpu"))


def inputs(cfg, B, S, seed):
    """A numpy batch: tokens (B, S) int32, and random media (B, n_media, d)
    or frames (B, encoder_seq, d), f32."""
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.cross_attn_every:
        batch["media"] = r.normal(size=(B, cfg.n_media_tokens, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        batch["enc_frames"] = r.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    return batch


def jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def th(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def np_leaves(cache):
    """A cache tree (torch or jax leaves) as {path: ndarray}."""
    def conv(t):
        return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    def rec(tree):
        return {k: rec(v) for k, v in tree.items()} if isinstance(tree, dict) else conv(tree)
    return flatten(rec(cache))


def tree_shapes(tree):
    """A cache tree's leaves as {path: shape}."""
    return {k: tuple(v.shape) for k, v in np_leaves(tree).items()}


# --------------------------------------------------------------------------
# checks both families run the same way
# --------------------------------------------------------------------------

def check_logits_and_splits(f: Family, seed: int) -> np.ndarray:
    """Logits within 5e-4 of the reference's, the reference's legal cuts,
    and split = full at each. Returns the port's logits."""
    batch = inputs(f.cfg, 2, PROMPT, seed)
    want = np.asarray(jax_forward_logits(f.jcfg, f.params, jx(batch)))
    got = forward_logits(f.cfg, f.model, th(batch))
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)
    assert cut_points(f.cfg) == jax_cut_points(f.jcfg)
    for cut in cut_points(f.cfg):
        torch.testing.assert_close(split_forward(f.cfg, f.model, th(batch), cut), got,
                                   rtol=2e-4, atol=2e-4)
    return got.numpy()


def _traced_w8(f: Family, batch, cut):
    """One w8 infer in each package with every activation quantization
    recorded in call order (the projections' and the link's): the
    reference eagerly (under ``jax.disable_jit``, so its calls see values),
    the port on the CPU. Returns (reference logits, port logits, act bytes
    of each, [(x, codes, scale) of the reference], [... of the port])."""
    import repro.kernels.ops as jops
    import repro.quant as jquant
    import repro_torch.kernels.ops as tops
    import repro_torch.serving.engine as tengine
    jrec, trec = [], []

    def recorder(fn, rec, conv):
        def quantize_act(x):
            q, scale = fn(x)
            rec.append(tuple(conv(t) for t in (x, q, scale)))
            return q, scale
        return quantize_act

    saved = [(m, m.quantize_act) for m in (jops, jquant, tops, tengine)]
    try:
        for m in (jops, jquant):
            m.quantize_act = recorder(m.quantize_act, jrec, np.asarray)
        for m in (tops, tengine):
            m.quantize_act = recorder(m.quantize_act, trec, lambda t: t.numpy().copy())
        with jax.disable_jit():
            want, want_bytes = JaxSplitServingEngine(f.jcfg, f.params, ("w8",)).infer(
                jx(batch), cut, "w8")
        got, got_bytes = SplitServingEngine(f.cfg, f.model, ("w8",), device="cpu").infer(
            batch, cut, "w8")
    finally:
        for m, fn in saved:
            m.quantize_act = fn
    return np.asarray(want), got.numpy(), want_bytes, got_bytes, jrec, trec


def check_w8_against_reference(f: Family, batch, cut, qerr_max) -> None:
    """w8 at one cut, held as the other families' files hold it where no
    int8 code flips, and by where the first flip comes from where one does.

    An f32 difference upstream of an activation quantization (sums in
    another order) can move x / scale across a half-way point and flip a
    code by one step; each later layer then quantizes other inputs, so
    the flips cascade (in the reduced whisper, one code of the first
    encoder layer grows to thousands in the decoder), and the logits' gap
    grows with the cascade, not with a fault. So: act_bytes exact; the gap
    within W8_GAP_MAX of the reference's own w8 error (its max against its
    bf16 logits) at every cut; every quantization's input and codes in
    the same order on both sides; and either no code differs anywhere and
    the logits agree within 5e-4, or the first call whose codes differ
    has inputs that agree within f32 rounding and differs only by single
    steps at half-way points."""
    want, got, want_bytes, got_bytes, jrec, trec = _traced_w8(f, batch, cut)
    assert got_bytes == want_bytes == batch["tokens"].size * (f.cfg.d_model + 4)
    assert np.abs(got - want).max() <= W8_GAP_MAX * qerr_max, (cut, np.abs(got - want).max())
    assert [r[1].shape for r in trec] == [r[1].shape for r in jrec] and jrec
    flips = [i for i, (j, t) in enumerate(zip(jrec, trec)) if (j[1] != t[1]).any()]
    if not flips:
        np.testing.assert_allclose(got, want, **MODEL_TOL)
        return
    (jx_, jq, js), (tx, tq, ts) = jrec[flips[0]], trec[flips[0]]
    np.testing.assert_allclose(tx, jx_, rtol=1e-5, atol=1e-5 * (1 + np.abs(jx_).max()))
    moved = jq != tq
    steps = np.abs(jq.astype(np.int32) - tq.astype(np.int32))[moved]
    t = (jx_ / js)[moved]
    assert (steps == 1).all(), (cut, flips[0], steps.max())
    assert (np.abs(np.abs(t - np.floor(t)) - 0.5) < 1e-2).all(), (cut, flips[0], t)


def check_split_serving(f: Family, version: str, seed: int) -> None:
    """SplitServingEngine against the reference's at every cut: act_bytes
    exact, logits within 5e-4; w8 as ``check_w8_against_reference`` says."""
    batch = inputs(f.cfg, 2, PROMPT, seed)
    jeng = JaxSplitServingEngine(f.jcfg, f.params, ("bf16", version))
    eng = SplitServingEngine(f.cfg, f.model, (version,), device="cpu")
    link = cut_activation_bytes(f.cfg, batch["tokens"].shape)
    assert link == 2 * PROMPT * f.cfg.d_model * 4
    for cut in cut_points(f.cfg):
        want, want_bytes = jeng.infer(jx(batch), cut, version)
        if version == "w8":
            qerr = np.abs(np.asarray(want) - np.asarray(jeng.infer(jx(batch), cut, "bf16")[0]))
            check_w8_against_reference(f, batch, cut, qerr.max())
            continue
        got, got_bytes = eng.infer(batch, cut, version)
        assert got_bytes == want_bytes == link
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def check_prefill_and_decode(f: Family, seed: int) -> None:
    """Caches leaf by leaf (rings, cross caches and a repeated sub's
    (steps, repeat) leaves) and logits after the prefill and after each of
    NEW teacher-forced decode steps."""
    batch = inputs(f.cfg, 2, PROMPT, seed)
    total = PROMPT + NEW
    want, jcache = jax_prefill(f.jcfg, f.params, jx(batch), total_len=total)
    got, cache = prefill(f.cfg, f.model, th(batch), total_len=total)
    r = np.random.default_rng(seed + 1)
    for step in range(NEW + 1):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
        jflat, flat = np_leaves(jcache), np_leaves(cache)
        assert sorted(flat) == sorted(jflat)
        for key in jflat:
            assert flat[key].shape == jflat[key].shape, key
            np.testing.assert_allclose(flat[key], jflat[key], **TOL, err_msg=key)
        if step == NEW:
            return
        tok = r.integers(0, f.cfg.vocab_size, 2).astype(np.int32)
        want, jcache = jax_decode_step(f.jcfg, f.params, jcache, jnp.asarray(tok),
                                       jnp.int32(PROMPT + step))
        got, cache = decode_step(f.cfg, f.model, cache, torch.from_numpy(tok).long(),
                                 PROMPT + step)


def check_cache_trees(cfg, jcfg) -> None:
    """init_cache's shapes and cache_axes equal the reference's trees."""
    assert tree_shapes(init_cache(cfg, 3, 20, device="cpu")) \
        == tree_shapes(jax_init_cache(jcfg, 3, 20))
    assert cache_axes(cfg) == jax_cache_axes(jcfg)


def check_plan(cfg, jcfg) -> None:
    """Keys in the reference's flattening order, shapes and dtypes."""
    want = {"/".join(str(p.key) for p in kp): leaf for kp, leaf in
            jax.tree_util.tree_flatten_with_path(jax_abstract_params(jcfg))[0]}
    plan = plan_model(cfg)
    assert list(plan) == list(want)
    for k, p in plan.items():
        assert p.shape == want[k].shape, k
        assert (p.dtype or cfg.param_dtype) == str(want[k].dtype), k


def full_param_count(arch, **overrides) -> int:
    """The plan's parameter count at full width, nothing materialised; the
    reference's too, which must agree."""
    plan = plan_model(get_config(arch).with_overrides(**overrides))
    n = sum(int(np.prod(p.shape)) for p in plan.values())
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(
        jax_abstract_params(jax_get_config(arch).with_overrides(**overrides))))
    assert n == want
    assert arch in ALL_ARCHS
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
    return n


def check_export(f: Family) -> None:
    out = export_params(f.model)
    assert list(out) == sorted(f.flat)
    for k in f.flat:
        assert out[k].dtype == f.flat[k].dtype, k
        np.testing.assert_array_equal(out[k], f.flat[k])


def quantized_leaves(f: Family, version: str):
    """(the port's QTensor leaf paths in the reference's naming, the
    reference's QTensor leaf paths); every float parameter of the quantized
    model is the float model's own tensor."""
    qmodel = build_version_params(f.cfg, f.model, (version,))[version]
    got = set()
    for name, mod in qmodel.named_modules():
        if isinstance(mod, Dense) and isinstance(mod.w, QTensor):
            assert mod.w.bits == (8 if version == "w8" else 4)
            got.add(name)
    jtree = jax_quantize_tree(f.params, "w8a8" if version == "w8" else "w4")
    want = {"/".join(str(k.key) for k in kp) for kp, leaf in
            jax.tree_util.tree_flatten_with_path(
                jtree, is_leaf=lambda x: isinstance(x, JaxQTensor))[0]
            if isinstance(leaf, JaxQTensor)}
    float_params = dict(f.model.named_parameters())
    for name, t in qmodel.named_parameters():
        assert t is float_params[name], name
    return got, want


def port_name(module_path: str, repeated=()) -> str:
    """A module path of the port (``stacks.period.0.attn.1.attn.wq``) in the
    reference's leaf naming (``stacks/period/attn/attn/wq``): the step index
    dropped, and a repeat index after each sub of ``repeated``."""
    parts = module_path.split(".")
    if parts[0] not in ("stacks", "enc_stacks"):
        return "/".join(parts)
    parts = parts[:2] + parts[3:]
    if parts[2] in repeated:
        parts = parts[:3] + parts[4:]
    return "/".join(parts)


def check_greedy(f: Family, seed: int) -> None:
    batch = inputs(f.cfg, 2, PROMPT, seed)
    want = JaxServingEngine(f.jcfg, f.params, JaxServeConfig(max_new_tokens=8)).generate(
        jx(batch))
    got = ServingEngine(f.cfg, f.model, ServeConfig(max_new_tokens=8), device="cpu").generate(
        batch)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def check_scheduler(f: Family, seed: int) -> None:
    """Mixed prompt lengths in left-padded cohorts with the reference's zero
    media or frames, individual retirement (the scheduler gathers the cross
    caches' slots with the rings'): streams and ServerStats equal."""
    r = np.random.default_rng(seed)
    specs = [(i, r.integers(0, f.cfg.vocab_size, int(r.integers(3, 30))).astype(np.int32),
              3 + i % 4) for i in range(5)]
    jsrv = JaxServer(f.jcfg, f.params, max_batch=3, cache_len=40)
    srv = ContinuousBatchingServer(f.cfg, f.model, max_batch=3, cache_len=40, device="cpu")
    for rid, prompt, n_new in specs:
        jsrv.submit(JaxRequest(rid=rid, tokens=prompt, max_new_tokens=n_new))
        srv.submit(Request(rid=rid, tokens=prompt, max_new_tokens=n_new))
    jdone = sorted(jsrv.run(), key=lambda q: q.rid)
    done = sorted(srv.run(), key=lambda q: q.rid)
    assert [q.rid for q in done] == [q.rid for q in jdone] == list(range(5))
    for q, jq in zip(done, jdone):
        assert q.out == [int(t) for t in jq.out], q.rid
    assert srv.stats.slot_reclaims > 0
    assert dataclasses.asdict(srv.stats) == dataclasses.asdict(jsrv.stats)


def check_execute(arch: str) -> None:
    """The tpu-execute preset over the reduced arch: the same summary bit
    for bit, the same executed (version, cut) samples with every byte count
    exact, each batch the tokens plus the reference's zero media or
    frames."""
    ref_sc = ref_get_scenario("tpu-execute").replace(arch=arch, n_requests=600)
    sc = get_scenario("tpu-execute").replace(arch=arch, n_requests=600)
    policy = "greedy_oracle"
    ref = ref_run_scenario(ref_sc, (policy,))
    port = run_scenario(sc, (policy,), device="cpu")
    x, y = ref.results[policy], port.results[policy]
    assert y.per_seed == x.per_seed and y.mean == x.mean
    cx, cy = x.cross_check, y.cross_check
    assert cy["bytes_exact"] and cx["bytes_exact"] and cy["samples"] == cx["samples"] > 0
    keys = ("version", "cut", "j", "k", "expected_bytes", "measured_bytes")
    assert [{k: r[k] for k in keys} for r in cy["records"]] \
        == [{k: r[k] for k in keys} for r in cx["records"]]
    assert all(r["logits_finite"] for r in cy["records"])
    env_cfg, tables = T.make_tpu_env([arch], reduced=True, seq_len=8, device="cpu")
    ref_cfg, ref_tables = R.make_tpu_env([arch], reduced=True, seq_len=8)
    np.testing.assert_array_equal(tables.cut_bytes.numpy(), np.asarray(ref_tables.cut_bytes))


def check_serve_cli(arch: str) -> None:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--device", "cpu",
         "--batch", "2", "--prompt-len", "8", "--new-tokens", "4"],
        capture_output=True, text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines()[0].startswith("generated (2, 4) on cpu")
