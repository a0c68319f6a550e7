"""repro_torch's distribution stack against repro's on the CPU: the
parameter plan's logical axes, the parameter counts and MODEL_FLOPS, the
abstract inputs of every (arch x shape), ``resolve_spec`` on the reference
tests' stand-in meshes, the collective counter's bytes, and one dry-run
record through both packages' roofline and EdgeRL env."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.analysis import roofline as ref_roofline  # noqa: E402
from repro.configs import ALL_ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import roofline_env as ref_roofline_env  # noqa: E402
from repro.core import transformer_cost as ref_cost  # noqa: E402
from repro.launch import mesh as ref_mesh  # noqa: E402
from repro.launch import shardings as ref_sh  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import model as ref_model  # noqa: E402

from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.analysis.comm_cost import CommCost  # noqa: E402
from repro_torch.configs import ALL_ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.core import roofline_env, transformer_cost  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.launch import steps as st  # noqa: E402
from repro_torch.models import cache_axes, n_params, param_axes  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    """The reference tests' stand-in mesh: axis names and a shape dict."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = names


SINGLE = FakeMesh((16, 16), ("data", "model"))
MULTI = FakeMesh((2, 16, 16), ("pod", "data", "model"))


def _flat(tree, is_leaf=None):
    """{"a/b/c": leaf} of a JAX pytree of dicts."""
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(str(k.key) for k in path): v for path, v in leaves}


def _flat_port(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat_port(v, f"{prefix}{k}/"))
    return out


def _is_axes(x):
    return isinstance(x, tuple) and all(e is None or isinstance(e, str) for e in x)


def test_archs_and_shapes_are_the_references():
    assert set(ALL_ARCHS) == set(REF_ARCHS)
    assert SHAPES == ref_steps.SHAPES


def test_mesh_axis_helpers_and_constants():
    assert mesh_mod.data_axes(MULTI) == ref_mesh.data_axes(MULTI) == ("pod", "data")
    assert mesh_mod.model_axes(MULTI) == ("model",)
    assert mesh_mod.axis_size(MULTI, ("pod", "data")) == 32
    assert mesh_mod.axis_size(SINGLE, ("data",)) == 16
    # the H100 SXM's peaks, not the reference's TPU v5e ones
    assert (mesh_mod.PEAK_FLOPS_BF16, mesh_mod.HBM_BW, mesh_mod.NVLINK_BW) \
        == (989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_axes_and_counts_equal_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert param_axes(cfg) == _flat(ref_model.param_axes(ref_cfg), _is_axes)
    assert n_params(cfg) == ref_model.n_params(ref_cfg)
    assert transformer_cost.active_params(cfg) == ref_cost.active_params(ref_cfg)
    for name, info in SHAPES.items():
        args = (info["kind"], info["global_batch"], info["seq_len"])
        assert transformer_cost.model_flops(cfg, *args) \
            == ref_cost.model_flops(ref_cfg, *args), name


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_specs_equal_the_reference(arch, shape):
    """Shapes and dtypes of every abstract input leaf, by flattened path
    (``tests/test_launch_analysis.py``'s parametrization)."""
    cfg = get_config(arch).with_overrides(param_dtype="bfloat16", compute_dtype="bfloat16")
    ref_cfg = ref_get_config(arch).with_overrides(param_dtype="bfloat16",
                                                   compute_dtype="bfloat16")
    want = _flat(ref_steps.input_specs(ref_cfg, shape))
    got = _flat_port(st.input_specs(cfg, shape))
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert _dtype(got[k]) == str(v.dtype), k
        assert got[k].device.type == "meta", k


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_resolve_spec_equals_the_reference_on_every_leaf(arch):
    """Every parameter leaf and every cache leaf of both decode shapes, on
    (16, 16) and (2, 16, 16), fsdp off and on."""
    for mesh in (SINGLE, MULTI):
        for fsdp in (False, True):
            cfg = get_config(arch).with_overrides(fsdp=fsdp)
            ref_cfg = ref_get_config(arch).with_overrides(fsdp=fsdp)
            rules = sh.logical_rules(cfg, mesh)
            assert rules == ref_sh.logical_rules(ref_cfg, mesh)
            shapes = {k: tuple(v.shape) for k, v in st.input_specs(cfg, "train_4k")["params"].items()}
            leaves = [(ax, shapes[k]) for k, ax in param_axes(cfg).items()]
            for shape in ("decode_32k", "long_500k"):
                ccfg = st.config_for_shape(cfg, shape)
                info = SHAPES[shape]
                caches = _flat_port(st.cache_specs(ccfg, info["global_batch"], info["seq_len"]))
                axes = _flat_port(cache_axes(ccfg))
                leaves += [(axes[k], tuple(v.shape)) for k, v in caches.items()]
            for ax, shp in leaves:
                got = sh.resolve_spec(ax, shp, rules, mesh)
                want = ref_sh.resolve_spec(ax, shp, rules, mesh)
                assert tuple(got) == tuple(want), (ax, shp)


def test_fsdp_rules_and_placements():
    cfg = get_config("llama-3.2-vision-90b")
    r1 = sh.logical_rules(cfg.with_overrides(fsdp=True), SINGLE)
    assert sh.logical_rules(cfg, SINGLE)["embed"] == ()
    spec = sh.resolve_spec(("embed", "heads"), (8192, 8192), r1, SINGLE)
    assert tuple(spec) == ("data", "model")
    from torch.distributed.tensor import Replicate, Shard
    assert sh.placements(spec, SINGLE) == (Shard(0), Shard(1))
    assert sh.placements(sh.PartitionSpec(None, ("pod", "data"), None), MULTI) \
        == (Shard(1), Shard(1), Replicate())
    with pytest.raises(ValueError, match="axis order"):
        sh.placements(sh.PartitionSpec(("data", "pod")), MULTI)


# --------------------------------------------------------------------------
# the collective counter, on a fake group of 2 ranks
# --------------------------------------------------------------------------

@pytest.fixture
def fake_group_of_two():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_collective_bytes_follow_the_references_convention(fake_group_of_two):
    """26 all-gathers whose result is f32[4, 8] (as the reference test's
    loop body), all-reduce at twice its operand, reduce-scatter at its
    operand."""
    import torch.distributed._functional_collectives as funcol
    group = fake_group_of_two
    with CommCost() as cc:
        for _ in range(26):
            funcol.all_gather_tensor(torch.ones(2, 8), 0, group).wait()
        funcol.all_reduce(torch.ones(4, 8), "sum", group).wait()
        funcol.reduce_scatter_tensor(torch.ones(4, 8), "sum", 0, group).wait()
    out = cc.result()
    assert out["all-gather"] == 26 * 4 * 8 * 4
    assert out["n_all-gather"] == 26
    assert out["all-reduce"] == 2 * 4 * 8 * 4 and out["n_all-reduce"] == 1
    assert out["reduce-scatter"] == 4 * 8 * 4 and out["n_reduce-scatter"] == 1
    assert out["total_bytes"] == (26 + 2 + 1) * 4 * 8 * 4


def test_collectives_that_dtensor_runs_are_counted(fake_group_of_two):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))
    x = distribute_tensor(torch.ones(4, 8), mesh, [Shard(0)])
    w = distribute_tensor(torch.ones(8, 6), mesh, [Shard(0)])
    with CommCost() as cc:
        x.redistribute(mesh, [Replicate()])          # all-gather to f32[4, 8]
        y = x.redistribute(mesh, [Shard(1)]) @ w     # a partial sum (4, 6)
        y.redistribute(mesh, [Replicate()])          # all-reduce of f32[4, 6]
    out = cc.result()
    assert out["n_all-gather"] >= 1 and out["all-gather"] >= 4 * 8 * 4
    assert out["n_all-reduce"] == 1 and out["all-reduce"] == 2 * 4 * 6 * 4


# --------------------------------------------------------------------------
# one record through both packages
# --------------------------------------------------------------------------

RECORD = {"arch": "qwen2-0.5b", "shape": "train_4k", "mesh": "single",
          "devices": 256, "status": "ok",
          "jaxpr_flops": 256 * 197e12,          # 1 s at the reference's peak
          "jaxpr_bytes_fused": 256 * 819e9 / 2,  # 0.5 s
          "collectives": {"total_bytes": 256 * 50e9 / 4}}   # 0.25 s


def test_one_record_through_both_rooflines():
    ref, got = ref_roofline.enrich(RECORD), roofline.enrich(RECORD)
    assert got["compute_s"] / ref["compute_s"] == pytest.approx(197e12 / 989e12, rel=1e-12)
    assert got["memory_s"] / ref["memory_s"] == pytest.approx(819e9 / 3.35e12, rel=1e-12)
    assert got["collective_s"] / ref["collective_s"] == pytest.approx(50e9 / 450e9, rel=1e-12)
    assert got["dominant"] == ref["dominant"] == "compute"
    assert got["model_flops"] == ref["model_flops"] > 0
    assert got["ratio"] == ref["ratio"]
    assert roofline.table([RECORD]).splitlines()[2].startswith("| qwen2-0.5b | train_4k |")


def _profiles_close(a, b):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _profiles_close(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _profiles_close(x, y)
    elif isinstance(a, float) or hasattr(a, "shape"):
        np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                                   np.asarray(b, dtype=np.float64), rtol=1e-6, atol=0)
    else:
        assert a == b


def test_one_record_prices_both_packages_env(tmp_path):
    path = tmp_path / "dryrun.jsonl"
    recs = [dict(RECORD, arch=a, shape="prefill_32k", jaxpr_flops=f)
            for a, f in (("qwen2-0.5b", 3.3e16), ("falcon-mamba-7b", 4.9e17))]
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    ref_recs = ref_roofline_env._load_records(str(path))
    got_recs = roofline_env._load_records(str(path))
    assert got_recs == ref_recs
    for arch in ("qwen2-0.5b", "falcon-mamba-7b", "recurrentgemma-2b"):   # the last: no record
        _profiles_close(roofline_env.dryrun_profile(arch, got_recs),
                        ref_roofline_env.dryrun_profile(arch, ref_recs))
    archs = ["qwen2-0.5b", "falcon-mamba-7b"]
    ref_cfg, ref_tables = ref_roofline_env.make_dryrun_tpu_env(archs, results=str(path))
    cfg, tables = roofline_env.make_dryrun_tpu_env(archs, results=str(path), device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    for f in dataclasses.fields(ref_tables):
        a, b = getattr(ref_tables, f.name), getattr(tables, f.name)
        if hasattr(a, "shape"):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, err_msg=f.name)
        else:
            assert a == b, f.name


# --------------------------------------------------------------------------
# the kernels' local shards
# --------------------------------------------------------------------------

@pytest.mark.parametrize("H,HK", [(4, 2), (14, 2), (12, 8), (16, 16), (10, 1), (8, 4)])
def test_group_kv_gives_each_q_head_the_kv_head_it_reads(H, HK):
    """On every rank of every head split, local q head j reads local kv
    head j % HK' (the kernels' grouping), which must be global kv head
    (h0 + j) % HK (the reference's)."""
    from repro_torch.kernels.sharded import group_kv
    k = torch.arange(HK, dtype=torch.float32).view(1, HK, 1, 1)
    for ways in (m for m in range(1, H + 1) if H % m == 0):
        hl = H // ways
        for r in range(ways):
            kl, vl = group_kv(k, k, r * hl, hl)
            got = [int(kl[0, j % kl.shape[1]]) for j in range(hl)]
            assert got == [(r * hl + j) % HK for j in range(hl)], (ways, r)
            assert hl % kl.shape[1] == 0


class _Coord:
    def __init__(self, shape, coord):
        self.shape, self._coord = shape, coord

    def get_coordinate(self):
        return self._coord


def _chunk(x, n, dim, c):
    """DTensor's ``Shard``: torch.chunk's c-th piece, empty past the last."""
    pieces = x.chunk(n, dim=dim)
    return pieces[c] if c < len(pieces) else x.narrow(dim, 0, 0)


def test_local_slice_is_torch_chunks_split():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.kernels.sharded import local_slice
    x = torch.arange(2 * 10 * 6).view(2, 10, 6)
    for coord in [(a, b) for a in range(2) for b in range(4)]:
        mesh = _Coord((2, 4), coord)
        shape, off = local_slice(x.shape, mesh, (Shard(1), Shard(1)))
        want = _chunk(_chunk(x, 2, 1, coord[0]), 4, 1, coord[1])
        assert shape == tuple(want.shape)
        if shape[1]:
            assert torch.equal(x[:, off[1]:off[1] + shape[1]], want)
        shape, off = local_slice(x.shape, mesh, (Replicate(), Shard(2)))
        want = _chunk(x, 4, 2, coord[1])
        assert shape == tuple(want.shape)
        assert torch.equal(x[:, :, off[2]:off[2] + shape[2]], want)


def test_quantized_dense_runs_on_row_shards(fake_group_of_two):
    """A w8 projection of a sharded activation runs the int8 product on each
    rank's rows against the whole weight (the fake group moves no data, so
    rank 0 holds the first half of the rows)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.kernels.ops import quantized_dense
    from repro_torch.quant.quantize import quantize
    g = torch.Generator().manual_seed(3)
    x, w = torch.randn(6, 32, generator=g), torch.randn(32, 16, generator=g)
    qw = quantize(w, "w8a8")
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
    out = quantized_dense(distribute_tensor(x, mesh, [Shard(0)]), qw)
    assert out.placements == (Shard(0),) and out.shape == (6, 16)
    assert torch.equal(out.to_local(), quantized_dense(x, qw)[:3])


def test_distributed_start_up(monkeypatch):
    """No contract in the environment: nothing starts. The reference's
    contract starts a gloo group when the caller names the CPU."""
    import torch.distributed as dist
    from repro_torch.launch import distributed
    for key in ("REPRO_COORDINATOR", "REPRO_NUM_PROCESSES", "REPRO_PROCESS_ID", "RANK",
                "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(key, raising=False)
    assert distributed.maybe_initialize_distributed(device="cpu") is False
    assert distributed.describe_topology().startswith("process 0/1 ")
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("REPRO_COORDINATOR", f"localhost:{port}")
    monkeypatch.setenv("REPRO_NUM_PROCESSES", "1")
    monkeypatch.setenv("REPRO_PROCESS_ID", "0")
    try:
        assert distributed.maybe_initialize_distributed(device="cpu") is True
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert "global_devices=1" in distributed.describe_topology()
        mesh = mesh_mod.make_host_mesh(device="cpu")
        assert mesh_mod.axis_sizes(mesh) == {"data": 1, "model": 1}
        with pytest.raises(ValueError, match="needs 256 ranks"):
            mesh_mod.make_production_mesh(device="cpu")
    finally:
        dist.destroy_process_group()
