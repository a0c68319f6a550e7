"""``repro_torch.launch.serve_batch`` and ``repro_torch.launch.dev_smoke``
against the reference's ``examples/serve_batch.py`` and
``scripts/dev_smoke.py`` on the CPU, on the same weights: each script's
own init (``init(cfg, jax.random.key(0))`` at ``.reduced()`` size), written
by ``repro.checkpointing.save_tree`` and read by the port's ``--weights``.

serve_batch: the reference script runs as its own ``main`` (small sizes on
its command line), its engine's greedy tokens recorded; the port's equal
them for all four archs, every row. dev_smoke: the reference script runs as
its own ``main`` over one arch of each family, the outputs of the functions
it jits recorded (the loss, the prefill's and the decode step's logits);
the port's loss is within 5e-4 and its greedy tokens of the prefill and of
the decode step are equal, and both print OK with the same loss."""
import contextlib
import importlib.util
import io
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.checkpointing import save_tree as jax_save_tree  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import init as ref_init  # noqa: E402

from repro_torch.launch import dev_smoke, serve_batch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_ARGV = ["--new-tokens", "6", "--batch", "2", "--prompt-len", "8"]
# one arch of each family: dense, MoE with MLA, SSM, hybrid, vlm, audio
DEV_ARCHS = ["qwen2-0.5b", "deepseek-v2-lite-16b", "falcon-mamba-7b", "recurrentgemma-2b",
             "llama-3.2-vision-90b", "whisper-large-v3"]
LOSS_TOL = 5e-4


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.delenv("REPRO_USE_PALLAS", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(rel, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The directory of <arch>.npz: each reference script's own init."""
    d = tmp_path_factory.mktemp("weights")
    for arch in sorted(set(serve_batch.ARCHS) | set(DEV_ARCHS)):
        jax_save_tree(str(d / f"{arch}.npz"),
                      ref_init(ref_get_config(arch).reduced(), jax.random.key(0)))
    return str(d)


@pytest.fixture(scope="module")
def serve_runs(weights):
    """(the reference script's tokens, its printed samples, the port's
    tokens), {arch: ...} each."""
    mod = _script("examples/serve_batch.py", "ref_serve_batch")
    assert mod.ARCHS == serve_batch.ARCHS
    ref_tokens = []

    class Recording(mod.ServingEngine):
        def generate(self, batch, *a, **kw):
            out = super().generate(batch, *a, **kw)
            ref_tokens.append(np.asarray(out))
            return out

    mod.ServingEngine = Recording
    buf = io.StringIO()
    argv = sys.argv
    sys.argv = ["serve_batch.py", *SERVE_ARGV]
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        sys.argv = argv
    samples = {line.split()[0]: [int(x) for x in re.search(r"sample=\[(.*)\]", line)
                                 .group(1).split(",")]
               for line in buf.getvalue().splitlines() if "sample=" in line}
    got = serve_batch.main([*SERVE_ARGV, "--device", "cpu", "--weights", weights])
    return dict(zip(mod.ARCHS, ref_tokens)), samples, got


@pytest.mark.parametrize("arch", serve_batch.ARCHS)
def test_serve_batch_greedy_tokens_equal_the_reference_scripts(serve_runs, arch):
    ref_tokens, samples, got = serve_runs
    assert got[arch].dtype == torch.int64 and got[arch].shape == (2, 6)
    np.testing.assert_array_equal(got[arch].numpy(), ref_tokens[arch])
    assert got[arch][0, :6].tolist() == samples[arch]


@pytest.fixture(scope="module")
def dev_runs(weights):
    """({arch: the reference script's loss and greedy tokens, from the
    outputs of the functions it jits}, its printed losses, the port's
    results, the port's printed losses)."""
    mod = _script("scripts/dev_smoke.py", "ref_dev_smoke")
    outs, jit = [], jax.jit

    def recording_jit(fn, *a, **kw):
        compiled = jit(fn, *a, **kw)

        def run(*args, **kwargs):
            out = compiled(*args, **kwargs)
            outs.append(out)
            return out
        return run

    buf = io.StringIO()
    argv = sys.argv
    sys.argv = ["dev_smoke.py", *DEV_ARCHS]
    jax.jit = recording_jit
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        jax.jit, sys.argv = jit, argv
    # per arch: forward_train, prefill, decode_step
    assert len(outs) == 3 * len(DEV_ARCHS)
    ref = {arch: {"loss": float(outs[3 * i][0]),
                  "prefill_tokens": np.asarray(jnp.argmax(outs[3 * i + 1][0], -1)),
                  "decode_tokens": np.asarray(jnp.argmax(outs[3 * i + 2][0], -1))}
           for i, arch in enumerate(DEV_ARCHS)}
    port_buf = io.StringIO()
    with contextlib.redirect_stdout(port_buf):
        got = dev_smoke.main([*DEV_ARCHS, "--device", "cpu", "--weights", weights])

    def losses(text):
        return {m.group(1): float(m.group(2))
                for m in re.finditer(r"^OK (\S+) .*loss=(\S+)$", text, re.M)}
    return ref, losses(buf.getvalue()), got, losses(port_buf.getvalue())


@pytest.mark.parametrize("arch", DEV_ARCHS)
def test_dev_smoke_equals_the_reference_script(dev_runs, arch):
    ref, ref_printed, got, printed = dev_runs
    assert abs(got[arch]["loss"] - ref[arch]["loss"]) <= LOSS_TOL * abs(ref[arch]["loss"])
    for key in ("prefill_tokens", "decode_tokens"):
        np.testing.assert_array_equal(got[arch][key].numpy(), ref[arch][key])
    # both scripts checked this arch and printed its loss to 3 decimals
    assert abs(printed[arch] - ref_printed[arch]) <= 1e-3 + LOSS_TOL * abs(ref_printed[arch])


def test_dev_smoke_batch_is_the_reference_scripts():
    mod = _script("scripts/dev_smoke.py", "ref_dev_smoke")
    for arch in ("llama-3.2-vision-90b", "whisper-large-v3"):
        cfg = ref_get_config(arch).reduced()
        want, got = mod.batch_for(cfg), dev_smoke.batch_for(cfg)
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
