"""repro_torch's vlm family (llama-3.2-vision-90b: gated cross-attention
image layers every ``cross_attn_every`` slots) against repro on the CPU.

Two configurations: ``.reduced()`` (4 layers, ``cross_attn_every`` 2: a
``period`` stack of (attn, xattn) steps, 8 media tokens) and the reduced
widths at 11 layers with ``cross_attn_every`` 5, whose period holds a sub
of 4 repeated ``attn`` blocks and whose remainder is a 1-layer ``tail``.
Weights cross as a ``save_tree`` .npz file with nonzero gates and norm
scales drawn from a seed, and every batch carries random media: the
cross-attention layer against ``apply_cross_attn``, the one-token cross
route, the ``xattn`` block, logits (also through the Pallas interpreter),
split serving in bf16/w8/w4, caches and decode, greedy decode, the
scheduler (with the reference's zero media), the plan and parameter
counts, export, quantization, the execute backend, the serve CLI and the
degeneracy guard."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import forward_logits as jax_forward_logits  # noqa: E402
from repro.models.attention import apply_cross_attn  # noqa: E402
from repro.models.attention_core import plain_attention as jax_plain_attention  # noqa: E402
from repro.models.blocks import apply_block  # noqa: E402

import torch_cross_common as C  # noqa: E402
from torch_cross_common import one_thread  # noqa: E402,F401
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.partition import cut_points  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import forward_logits, stack_defs  # noqa: E402
from repro_torch.models.attention import CrossAttention  # noqa: E402
from repro_torch.models.blocks import XAttnBlock  # noqa: E402
from repro_torch.models.model import Sub  # noqa: E402

ARCH = "llama-3.2-vision-90b"
CONFIGS = {"reduced": {}, "repeat 4 + tail": dict(n_layers=11, cross_attn_every=5)}


@pytest.fixture(scope="module")
def vlm(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = C.build(ARCH, tmp_path_factory.mktemp("npz"), **CONFIGS[name])
        return cache[name]
    return get


def test_stacks_hold_the_period_the_repeat_and_the_tail(vlm):
    """The stacks the reference scans: (attn, xattn) steps at .reduced();
    at 11 layers two steps of (4 repeated attn, xattn) and a 1-layer tail,
    the repeat an nn.ModuleList in each step."""
    small, big = vlm("reduced"), vlm("repeat 4 + tail")
    assert [(s.name, s.length, s.subs) for s in stack_defs(small.cfg)] == [
        ("period", 2, (Sub("attn", "attn"), Sub("xattn", "xattn")))]
    assert [(s.name, s.length, s.subs) for s in stack_defs(big.cfg)] == [
        ("period", 2, (Sub("attn", "attn", 4), Sub("xattn", "xattn"))),
        ("tail", 1, (Sub("blk", "attn"),))]
    step = big.model.stacks["period"][1]
    assert isinstance(step.attn, torch.nn.ModuleList) and len(step.attn) == 4
    assert isinstance(step.xattn, XAttnBlock)
    assert cut_points(big.cfg) == [("period", 1), ("period", 2), ("tail", 0), ("tail", 1)]
    assert tuple(big.flat["stacks/period/attn/attn/wq"].shape) == (2, 4, 256, 256)


# --------------------------------------------------------------------------
# the cross-attention layer, the one-token route, the xattn block
# --------------------------------------------------------------------------

def _layer_params(f, step=0):
    """The reference's step-``step`` xattn leaves and the port's block."""
    p = jax.tree.map(lambda a: a[step], f.params["stacks"]["period"]["xattn"])
    return p, f.model.stacks["period"][step].xattn


# (query tokens, where k and v come from, the port's mode)
CROSS_CASES = [(24, "kv_src", "train"), (24, "cache", "train"), (1, "kv_src", "prefill"),
               (1, "cache", "decode")]


@pytest.mark.parametrize("S,source,mode", CROSS_CASES)
def test_cross_attention_matches_reference(vlm, S, source, mode):
    """Against ``apply_cross_attn`` within 2e-5, Sq != Skv: from the media,
    and from a cache of (xk, xv) projected first; a one-token decode step
    goes through the port's decode route."""
    f = vlm("reduced")
    p, block = _layer_params(f)
    layer = block.xattn
    assert isinstance(layer, CrossAttention)
    r = np.random.default_rng(S)
    x = r.normal(size=(2, S, f.cfg.d_model)).astype(np.float32)
    media = r.normal(size=(2, f.cfg.n_media_tokens, f.cfg.d_model)).astype(np.float32)
    _, jcache = apply_cross_attn(f.jcfg, p["xattn"], jnp.asarray(x), kv_src=jnp.asarray(media))
    _, cache = layer(torch.from_numpy(x), kv_src=torch.from_numpy(media))
    for key in ("xk", "xv"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]), **C.TOL)
    if source == "kv_src":
        want, _ = apply_cross_attn(f.jcfg, p["xattn"], jnp.asarray(x), kv_src=jnp.asarray(media))
        got, new = layer(torch.from_numpy(x), kv_src=torch.from_numpy(media), mode=mode)
    else:
        want, _ = apply_cross_attn(f.jcfg, p["xattn"], jnp.asarray(x), cache=jcache)
        got, new = layer(torch.from_numpy(x), cache=cache, mode=mode)
        assert new is cache
    assert tuple(got.shape) == (2, S, f.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **C.TOL)


@pytest.mark.parametrize("H,HK,Skv,D", [(4, 2, 8, 64), (8, 1, 37, 64), (64, 8, 1601, 128),
                                        (20, 20, 1500, 64)])
def test_one_token_cross_route_matches_reference_attention(H, HK, Skv, D):
    """The decode route's plain version (the cache as a full ring at pos =
    Skv - 1, C = Skv, no window) against the reference's unmasked plain
    attention, at the reduced shape, GQA, and both families' published
    cross shapes."""
    r = np.random.default_rng(Skv)
    q = r.normal(size=(2, 1, H, D)).astype(np.float32)
    k, v = (r.normal(size=(2, Skv, HK, D)).astype(np.float32) for _ in range(2))
    want = jax_plain_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               q_positions=jnp.zeros((1,), jnp.int32),
                               kv_positions=jnp.zeros((Skv,), jnp.int32), causal=False,
                               window=None)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    got = ops.decode_attention(torch.from_numpy(q)[:, 0], kt.transpose(1, 2), vt.transpose(1, 2),
                               Skv - 1)[:, None]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **C.TOL)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_xattn_block_matches_reference(vlm, mode):
    """The gated block against ``apply_block(..., "xattn", ...)`` within
    2e-5 with nonzero gates and random media: a 24-token prompt, and one
    token reading the prefill's cache."""
    f = vlm("reduced")
    p, block = _layer_params(f, 1)
    assert float(block.gate_attn) != 0 and float(block.gate_mlp) != 0
    r = np.random.default_rng(3)
    x = r.normal(size=(2, 24, f.cfg.d_model)).astype(np.float32)
    media = r.normal(size=(2, f.cfg.n_media_tokens, f.cfg.d_model)).astype(np.float32)
    pre = "train" if mode == "train" else "prefill"
    want, jcache, _ = apply_block(f.jcfg, "xattn", p, jnp.asarray(x), mode=pre, pos0=0,
                                  kv_src=jnp.asarray(media))
    got, cache = block(torch.from_numpy(x), mode=pre, kv_src=torch.from_numpy(media))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **C.TOL)
    assert (cache is None) == (jcache is None) == (mode == "train")
    if mode == "train":
        return
    assert sorted(cache) == sorted(jcache) == ["xk", "xv"]
    x1 = r.normal(size=(2, 1, f.cfg.d_model)).astype(np.float32)
    want, jnew, _ = apply_block(f.jcfg, "xattn", p, jnp.asarray(x1), mode="decode", pos0=24,
                                cache=jcache)
    got, new = block(torch.from_numpy(x1), pos0=24, mode="decode", cache=cache)
    assert new is cache
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **C.TOL)


# --------------------------------------------------------------------------
# the model: logits, split serving, caches and decode, serving
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_logits_match_reference(vlm, name):
    C.check_logits_and_splits(vlm(name), 6)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_logits_match_reference_through_pallas_interpret(vlm, name, monkeypatch):
    """The reference's self-attention reaches its Pallas kernel (its cross
    attention, Sq != Skv, stays plain)."""
    f = vlm(name)
    batch = C.inputs(f.cfg, 2, C.PROMPT, 12)
    monkeypatch.setenv("REPRO_USE_PALLAS", "interpret")
    want = jax_forward_logits(f.jcfg, f.params, C.jx(batch))
    monkeypatch.delenv("REPRO_USE_PALLAS")
    got = forward_logits(f.cfg, f.model, C.th(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **C.MODEL_TOL)


@pytest.mark.parametrize("version", ["bf16", "w8", "w4"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_split_serving_matches_reference_engine(vlm, name, version):
    C.check_split_serving(vlm(name), version, 7)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_cache_and_decode_steps_match_reference(vlm, name):
    C.check_prefill_and_decode(vlm(name), 8)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cache_tree_and_axes_equal_reference(vlm, name):
    f = vlm(name)
    C.check_cache_trees(f.cfg, f.jcfg)
    axes = C.cache_axes(f.cfg)["period"]
    assert axes["xattn"]["xk"] == ("layers", "batch", None, "kv_heads", None)
    lead = ("layers", "layers") if name == "repeat 4 + tail" else ("layers",)
    assert axes["attn"]["k"] == lead + ("batch", "kv_cache_seq", "kv_heads", None)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_serving_engine_greedy_tokens_equal_reference(vlm, name):
    C.check_greedy(vlm(name), 10)


def test_continuous_batching_equals_reference(vlm):
    C.check_scheduler(vlm("repeat 4 + tail"), 11)


# --------------------------------------------------------------------------
# weights: the plan, export, quantization
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_plan_matches_reference_leaf_by_leaf(vlm, name):
    f = vlm(name)
    C.check_plan(f.cfg, f.jcfg)
    plan = C.plan_model(f.cfg)
    gate = plan["stacks/period/xattn/gate_attn"]
    assert gate.init == "zeros" and gate.dtype == "float32" and gate.shape == (2, 1)


@pytest.mark.parametrize("layers,every,want", [(100, 5, 87_666_794_536),
                                               (11, 5, 11_513_552_900),
                                               (2, 2, 3_812_663_298)])
def test_full_plan_counts_the_parameters(layers, every, want):
    """From the plan alone: the published 100 layers, the 11 that
    chip_smoke.py serves on one card, and the 2 (one attn, one xattn) it
    compares with the CPU."""
    assert C.full_param_count(ARCH, n_layers=layers, cross_attn_every=every) == want


@pytest.mark.parametrize("name", list(CONFIGS))
def test_export_roundtrips_reference_params(vlm, name):
    C.check_export(vlm(name))


@pytest.mark.parametrize("version", ["w8", "w4"])
def test_quantize_tree_quantizes_the_references_leaves(vlm, version):
    """Every projection of the repeated attn blocks, the cross-attention and
    the MLPs, and the untied head; the gates and norms stay the float
    model's tensors."""
    f = vlm("repeat 4 + tail")
    got, want = C.quantized_leaves(f, version)
    assert {C.port_name(n, repeated=("attn",)) for n in got} == want
    assert len([n for n in got if n.startswith("stacks.period.0.attn.")]) == 4 * 7
    assert {n.rsplit("/", 1)[1] for n in want if "/xattn/xattn/" in n} == {"wq", "wk", "wv",
                                                                          "wo"}


# --------------------------------------------------------------------------
# the controller's execute backend, the CLI, the degeneracy guard
# --------------------------------------------------------------------------

def test_execute_over_vlm_matches_reference():
    C.check_execute(ARCH)


def test_serve_cli_runs_vlm_on_the_cpu():
    C.check_serve_cli(ARCH)


def test_config_matches_reference():
    import dataclasses
    from repro.configs import get_config as jax_get_config
    for ref, port in ((jax_get_config(ARCH), get_config(ARCH)),
                      (jax_get_config(ARCH).reduced(), get_config(ARCH).reduced())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_degeneracy_guard_the_gates_move_the_logits(vlm, name):
    """With every gate set to zero the xattn layers add nothing; on each
    side the logits then move by more than 100x the parity tolerance, so
    the parity tests above hold a cross path that counts."""
    f = vlm(name)
    batch = C.inputs(f.cfg, 2, C.PROMPT, 6)
    base = forward_logits(f.cfg, f.model, C.th(batch))
    jbase = np.asarray(jax_forward_logits(f.jcfg, f.params, C.jx(batch)))
    gates = [m for m in f.model.modules() if isinstance(m, XAttnBlock)]
    saved = [(m.gate_attn.data.clone(), m.gate_mlp.data.clone()) for m in gates]
    try:
        for m in gates:
            m.gate_attn.data.zero_()
            m.gate_mlp.data.zero_()
        cut = forward_logits(f.cfg, f.model, C.th(batch))
    finally:
        for m, (a, b) in zip(gates, saved):
            m.gate_attn.data.copy_(a)
            m.gate_mlp.data.copy_(b)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.zeros_like(a) if str(path[-1].key) in C.GATES else a, f.params)
    jcut = np.asarray(jax_forward_logits(f.jcfg, jparams, C.jx(batch)))
    limit = C.GUARD * C.MODEL_TOL["atol"]
    assert (base - cut).abs().max().item() > limit
    assert np.abs(jbase - jcut).max() > limit
    np.testing.assert_allclose(cut.numpy(), jcut, **C.MODEL_TOL)
