"""repro_torch against repro: configuration, .npz interchange, import
hygiene and device rules of the port's entry points (CPU)."""
import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro_torch  # noqa: E402
from repro.checkpointing import load_tree as jax_load_tree  # noqa: E402
from repro.checkpointing import save_tree as jax_save_tree  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import init as jax_init  # noqa: E402
from repro_torch.checkpointing import flatten, load_tree, save_tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import init, load_jax_params  # noqa: E402
from repro_torch.models import init_cache  # noqa: E402
from repro_torch.serving import (ContinuousBatchingServer, ServingEngine,  # noqa: E402
                                 SplitServingEngine)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("reduced", [False, True])
def test_qwen2_config_matches_reference(reduced):
    ref, port = jax_get_config("qwen2-0.5b"), get_config("qwen2-0.5b")
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.resolved_head_dim == ref.resolved_head_dim
    assert port.pdtype == torch.float32 and port.cdtype == torch.float32


def test_npz_reference_file_loads_into_port(tmp_path):
    cfg = jax_get_config("qwen2-0.5b").reduced()
    params = jax_init(cfg, jax.random.key(0))
    path = str(tmp_path / "ref.npz")
    jax_save_tree(path, params, meta={"arch": cfg.name, "step": 3})
    flat, meta = load_tree(path)
    assert meta == {"arch": cfg.name, "step": 3}
    want = {"/".join(str(p.key) for p in kp): np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert set(flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k])
    model = load_jax_params(get_config("qwen2-0.5b").reduced(), flat, device="cpu")
    assert model.tok_embed.shape == (cfg.vocab_size, cfg.d_model)


def test_npz_port_file_loads_into_reference(tmp_path):
    cfg = jax_get_config("qwen2-0.5b").reduced()
    like = jax_init(cfg, jax.random.key(1))
    r = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: r.normal(size=a.shape).astype(np.float32), like)
    path = str(tmp_path / "port.npz")
    save_tree(path, tree, meta={"from": "repro_torch"})
    got, meta = jax_load_tree(path, like)
    assert meta == {"from": "repro_torch"}
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert set(flatten(tree)) == set(load_tree(path)[0])


def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_reference():
    bad = []
    assert {"llama_3_2_vision_90b.py", "whisper_large_v3.py", "blocks.py",
            "chip_smoke.py"} <= {path.name for path in _port_sources()}
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} imports {name}")
    assert not bad, bad


_IMPORT_EACH_FIRST = """
import importlib, sys
names = sys.argv[1:]
for name in names:
    for key in [k for k in sys.modules if k.split(".")[0] == "repro_torch"]:
        del sys.modules[key]
    importlib.import_module(name)
from repro_torch.kernels import _build
assert _build._LIBS == {}, _build._LIBS
print(len(names))
"""


def test_every_module_imports_first_and_builds_nothing():
    """Each module imports on its own, before any other module of the port
    (no import cycle bites whatever a caller imports first), and importing
    compiles and loads no kernel."""
    names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                         "repro_torch."))
    for name in ("kernels.flash_attention", "kernels.flash_decode", "kernels.mamba_scan",
                 "kernels.rglru_scan", "models.ssm", "models.rglru", "serving.scheduler",
                 "sim.metrics", "launch.serve", "configs.llama_3_2_vision_90b",
                 "configs.whisper_large_v3", "models.blocks", "sim.backends"):
        assert f"repro_torch.{name}" in names
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_EACH_FIRST, *names],
                         capture_output=True, text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == [str(len(names))]


def test_entry_points_raise_without_cuda_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        init(cfg, torch.Generator().manual_seed(0))
    model = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    flat = {k: v.numpy() for k, v in
            [("tok_embed", model.tok_embed.detach())]}
    with pytest.raises(RuntimeError, match="CUDA"):
        load_jax_params(cfg, flat)
    with pytest.raises(RuntimeError, match="CUDA"):
        SplitServingEngine(cfg, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        SplitServingEngine(cfg, model, device="cuda")
    eng = SplitServingEngine(cfg, model, device="cpu")
    assert eng.device == torch.device("cpu")
    for entry in (ServingEngine, ContinuousBatchingServer):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry(cfg, model)
        with pytest.raises(RuntimeError, match="CUDA"):
            entry(cfg, model, device="cuda")
        assert entry(cfg, model, device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 1, 8)
    assert init_cache(cfg, 1, 8, device="cpu")["main"]["blk"]["k"].device.type == "cpu"


def test_unported_families_raise():
    from repro_torch.models import stack_defs
    cfg = get_config("qwen2-0.5b").reduced()
    for kw in (dict(family="ssm"),
               dict(family="hybrid"),
               dict(family="vlm"),                # no cross_attn_every
               dict(family="audio"),              # no enc_dec
               dict(family="hybrid", block_pattern=("rec", "xattn"))):
        with pytest.raises(NotImplementedError):
            stack_defs(cfg.with_overrides(**kw))


def test_decode_profile_runs_chip_smokes_decode_shape():
    """The profile explains chip_smoke.py's decode path, so it takes its shape."""
    from repro_torch.launch import profile_decode
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    smoke = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], (ast.Name, ast.Tuple)):
            names = node.targets[0].elts if isinstance(node.targets[0], ast.Tuple) else node.targets
            values = node.value.elts if isinstance(node.value, ast.Tuple) else [node.value]
            for n, v in zip(names, values):
                if isinstance(n, ast.Name) and isinstance(v, ast.Constant):
                    smoke[n.id] = v.value
    for name in ("BATCH", "SEQ", "DEC_CACHE", "FM_BATCH", "FM_SEQ", "RG_BATCH", "RG_SEQ"):
        assert getattr(profile_decode, name) == smoke[name], name


def test_decode_profile_idle_share_refuses_device_time_beyond_the_wall():
    from repro_torch.launch.profile_decode import _idle_share
    assert _idle_share(8.0, 32.0) == 0.75
    assert _idle_share(32.0, 32.0) == 0.0
    with pytest.raises(ValueError, match="exceeds the wall time"):
        _idle_share(156.4, 87.1)
