"""repro_torch's continuous-batching scheduler against repro's on reduced
qwen2-0.5b (CPU): the six scenarios of tests/test_scheduler.py, each run
through both servers on the same weights (crossed as .npz) and the same
requests, with token streams, ServerStats counters and latency summaries
held equal. Plus the port's serving CLI on the CPU."""
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
from repro.models import init as jax_init  # noqa: E402
from repro.serving import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving.scheduler import ContinuousBatchingServer as JaxServer  # noqa: E402
from repro.serving.scheduler import Request as JaxRequest  # noqa: E402
from repro.sim.metrics import LATENCY_SCHEMA as JAX_LATENCY_SCHEMA  # noqa: E402
from repro_torch.checkpointing import load_tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import load_jax_params  # noqa: E402
from repro_torch.serving import (ContinuousBatchingServer, Request,  # noqa: E402
                                 ServeConfig, ServingEngine)
from repro_torch.sim.metrics import LATENCY_SCHEMA  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg = jax_get_config("qwen2-0.5b").reduced()
    cfg = get_config("qwen2-0.5b").reduced()
    params = jax_init(jcfg, jax.random.key(0))
    path = str(tmp_path_factory.mktemp("npz") / "qwen2.npz")
    jax_save_tree(path, params)
    model = load_jax_params(cfg, load_tree(path)[0], device="cpu")
    return jcfg, cfg, params, model


def _serve_both(setup, specs, *, max_batch, cache_len):
    """specs: [(rid, prompt, max_new_tokens, eos_id)]. Runs both servers
    and asserts equal streams, stats and latency summaries; returns the
    port's finished requests (sorted by rid) and server."""
    jcfg, cfg, params, model = setup
    jsrv = JaxServer(jcfg, params, max_batch=max_batch, cache_len=cache_len)
    srv = ContinuousBatchingServer(cfg, model, max_batch=max_batch,
                                   cache_len=cache_len, device="cpu")
    for rid, prompt, n_new, eos in specs:
        jsrv.submit(JaxRequest(rid=rid, tokens=prompt, max_new_tokens=n_new, eos_id=eos))
        srv.submit(Request(rid=rid, tokens=prompt, max_new_tokens=n_new, eos_id=eos))
    jdone = sorted(jsrv.run(), key=lambda q: q.rid)
    done = sorted(srv.run(), key=lambda q: q.rid)
    assert [q.rid for q in done] == [q.rid for q in jdone]
    for q, jq in zip(done, jdone):
        assert q.out == [int(t) for t in jq.out], q.rid
        for f in ("truncated", "submit_step", "first_token_step", "done_step"):
            assert getattr(q, f) == getattr(jq, f), (q.rid, f)
    assert dataclasses.asdict(srv.stats) == dataclasses.asdict(jsrv.stats)
    for slo in (None, 100.0, 5.0):
        np.testing.assert_equal(srv.stats.latency_summary(slo),
                                jsrv.stats.latency_summary(slo))
    return done, srv


def test_all_requests_complete(setup):
    cfg = setup[1]
    r = np.random.default_rng(1)
    specs = [(i, r.integers(0, cfg.vocab_size, int(r.integers(3, 10))).astype(np.int32),
              4 + i % 3, None) for i in range(8)]
    done, srv = _serve_both(setup, specs, max_batch=3, cache_len=64)
    assert len(done) == 8 and all(q.done for q in done)
    assert srv.stats.admitted == 8
    assert srv.stats.prefills >= 3


def test_matches_offline_engine(setup):
    """A same-prompt cohort gives the plain engine's tokens, in both
    packages."""
    jcfg, cfg, params, model = setup
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    n_new = 5
    want = np.asarray(JaxServingEngine(jcfg, params, JaxServeConfig(
        max_new_tokens=n_new, cache_len=64)).generate({"tokens": jnp.asarray(prompts)}))
    eng = ServingEngine(cfg, model, ServeConfig(max_new_tokens=n_new, cache_len=64),
                        device="cpu")
    np.testing.assert_array_equal(eng.generate({"tokens": prompts}).numpy(), want)
    done, _ = _serve_both(setup, [(i, prompts[i], n_new, None) for i in range(2)],
                          max_batch=2, cache_len=64)
    np.testing.assert_array_equal(np.asarray([q.out for q in done]), want)


def test_eos_early_stop(setup):
    prompt = np.arange(4, dtype=np.int32)
    probe, _ = _serve_both(setup, [(0, prompt, 1, None)], max_batch=1, cache_len=64)
    first = probe[0].out[0]
    done, _ = _serve_both(setup, [(0, prompt, 50, first)], max_batch=1, cache_len=64)
    assert done[0].out == [first]          # stopped at eos immediately


def test_individual_retirement_refills_slot(setup):
    """A finished request frees its slot for new admission while its
    cohort-mates keep decoding, and compaction keeps their streams."""
    jcfg, cfg, params, model = setup
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    n_long = 10
    want = ServingEngine(cfg, model, ServeConfig(max_new_tokens=n_long, cache_len=64),
                         device="cpu").generate({"tokens": prompts}).numpy()
    done, srv = _serve_both(setup, [(0, prompts[0], 2, None), (1, prompts[1], n_long, None),
                                    (2, prompts[0], 2, None)], max_batch=2, cache_len=64)
    assert [len(q.out) for q in done] == [2, n_long, 2]
    np.testing.assert_array_equal(done[1].out, want[1])
    assert srv.stats.slot_reclaims >= 1
    assert srv.stats.prefills == 2
    assert done[2].first_token_step < done[1].done_step


def test_per_request_latency_stats_schema(setup):
    done, srv = _serve_both(setup, [(i, np.arange(3, dtype=np.int32), 3, None)
                                    for i in range(4)], max_batch=2, cache_len=64)
    assert len(srv.stats.ttft_steps) == len(done) == 4
    assert len(srv.stats.e2e_steps) == 4
    assert all(t >= 1 for t in srv.stats.ttft_steps)
    assert all(e >= t for e, t in zip(srv.stats.e2e_steps, srv.stats.ttft_steps))
    assert LATENCY_SCHEMA == JAX_LATENCY_SCHEMA
    summ = srv.stats.latency_summary(slo_steps=100.0)
    for k in LATENCY_SCHEMA:
        assert k in summ, k
    assert summ["unit"] == "steps"
    assert summ["slo_attainment"] == 1.0


def test_ring_cache_overflow_truncates_instead_of_wrapping(setup):
    done, srv = _serve_both(setup, [(0, np.arange(8, dtype=np.int32), 100, None)],
                            max_batch=1, cache_len=16)
    assert done[0].truncated and done[0].done
    # prefill emits 1 token at pos 8; decode may run until pos hits 16
    assert len(done[0].out) == 1 + (16 - 8)
    assert srv.stats.truncated == 1
    # a prompt that cannot fit at all is rejected up front
    with pytest.raises(ValueError):
        srv.submit(Request(rid=1, tokens=np.arange(16, dtype=np.int32)))


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--batch", "2", "--prompt-len", "8", "--new-tokens", "4"],
        capture_output=True, text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("generated (2, 4) on cpu")
    assert lines[1].startswith("  seq0: [") and lines[2].startswith("  seq1: [")
