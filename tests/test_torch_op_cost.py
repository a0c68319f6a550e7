"""repro_torch.analysis.op_cost against repro.analysis.jaxpr_cost on the
CPU: the matmul FLOPs of the train (remat), prefill and serve steps at
``.reduced()`` size and 2 x 64 tokens equal the reference's ``dot_general``
FLOPs from ``analyze_jaxpr_by_op(jax.make_jaxpr(step)(...))`` on the same
config."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.analysis.jaxpr_cost import analyze_jaxpr, analyze_jaxpr_by_op  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402

from repro_torch.analysis.op_cost import OpCost, analyze_fn, analyze_fn_by_op, matmul_flops  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps as st  # noqa: E402
from repro_torch.models import init, init_cache, param_tree  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

B, S = 2, 64
KINDS = ("train", "prefill", "serve")
# The MoE archs' counts differ from the reference's by less than 1 %: the
# reference dispatches and combines tokens by one-hot einsums (dot_general
# FLOPs) where the port gathers and scatters them (bytes, no matmul), and
# in deepseek's train step the port's backward takes one more product (the
# gradient of the dispatch, which the reference's jaxpr leaves out).
MOE_RTOL = 1e-2


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_step(arch, kind):
    cfg = ref_get_config(arch).reduced()
    params = ref_model.abstract_params(cfg)
    if kind == "train":
        fn = ref_steps.make_train_step(cfg, RefAdamWConfig(), remat=True)
        args = (params, jax.eval_shape(ref_adamw_init, params), ref_steps.batch_specs(cfg, B, S))
    elif kind == "prefill":
        fn = ref_steps.make_prefill_step(cfg)
        args = (params, ref_steps.prefill_batch_specs(cfg, B, S))
    else:
        fn = ref_steps.make_serve_step(cfg)
        args = (params, ref_steps.cache_specs(cfg, B, S),
                jax.ShapeDtypeStruct((B,), jnp.int32), jax.ShapeDtypeStruct((), jnp.int32))
    return jax.make_jaxpr(fn)(*args)


def _port_step(arch, kind):
    """(step, its arguments) on CPU tensors drawn from a seed."""
    cfg = get_config(arch).reduced()
    model = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    batch = {}
    for k, v in st.batch_specs(cfg, B, S).items():
        if v.dtype == torch.int32:
            batch[k] = torch.as_tensor(rng.integers(0, cfg.vocab_size, v.shape), dtype=torch.int32)
        else:
            batch[k] = torch.as_tensor(rng.standard_normal(v.shape), dtype=v.dtype)
    if kind == "train":
        return (st.make_train_step(cfg, AdamWConfig(), remat=True),
                (model, adamw_init(param_tree(model)), batch))
    if kind == "prefill":
        del batch["targets"]
        return st.make_prefill_step(cfg), (model, batch)
    cache = init_cache(cfg, B, S, device="cpu")
    return st.make_serve_step(cfg), (model, cache, batch["tokens"][:, 0], S - 1)


def _flops_pair(arch, kind):
    ref = analyze_jaxpr_by_op(_ref_step(arch, kind))["dot_general"]["flops"]
    fn, args = _port_step(arch, kind)
    return ref, matmul_flops(analyze_fn_by_op(fn, *args))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "falcon-mamba-7b"])
def test_matmul_flops_equal_the_references_dot_flops(arch, kind):
    ref, got = _flops_pair(arch, kind)
    assert got == ref > 0


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "qwen3-0.6b", "starcoder2-3b",
                                  "phi3-medium-14b", "llama-3.2-vision-90b",
                                  "whisper-large-v3", "mixtral-8x22b",
                                  "deepseek-v2-lite-16b"])
def test_train_step_matmul_flops_of_the_other_archs(arch):
    ref, got = _flops_pair(arch, "train")
    if get_config(arch).moe:
        assert got == pytest.approx(ref, rel=MOE_RTOL)
    else:
        assert got == ref > 0


def test_totals_and_byte_bounds_against_the_reference():
    """The whole count of qwen2's prefill: the same matmul traffic
    (bytes_min's matmul share), and every total of the same order as the
    reference's (the elementwise ops differ op by op: torch's softmax,
    norms and RoPE are other primitives than jnp's)."""
    ref = analyze_jaxpr(_ref_step("qwen2-0.5b", "prefill"))
    fn, args = _port_step("qwen2-0.5b", "prefill")
    got = analyze_fn(fn, *args)
    for k in ("flops", "bytes", "bytes_min", "bytes_fused"):
        assert 0.5 * ref[k] < got[k] < 2.0 * ref[k], k
    assert got["bytes"] >= got["bytes_min"] >= got["bytes_fused"] > 0


def test_layout_and_zero_cost_ops_are_free():
    x = torch.ones(4, 8)
    with OpCost() as cost:
        y = x.view(8, 4).t().contiguous()
        (y > 0).logical_and(y < 2)
        torch.where(y > 0, y, y)
    assert cost.totals == {"flops": 0.0, "bytes": 0.0, "bytes_min": 0.0, "bytes_fused": 0.0}
    with OpCost() as cost:
        torch.exp(x)
        x @ torch.ones(8, 3)
    assert cost.totals["flops"] == 32 + 2 * 4 * 8 * 3
    assert cost.totals["bytes_min"] == (4 * 8 + 8 * 3 + 4 * 3) * 4
    assert cost.by_op["mm"]["count"] == 1
