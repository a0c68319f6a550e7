"""The comparison that decides ``correct``, driven through a whole run at the
CPU tests' small sizes (the harness's look for a card skipped): a sound run
comes out correct, and each fault a split-serving cell can have, planted
under the timed path, comes out not correct."""
import time

import pytest
import torch

from edgebench import harness
from edgebench.tests.small import small_config, small_mix

CELLS = {"starcoder2-3b.split-w8": ("starcoder2-3b", "split-w8"),
         "starcoder2-3b.split-f32": ("starcoder2-3b", "split-f32"),
         "falcon-mamba-7b.split-mix": ("falcon-mamba-7b", "split-mix")}


def skip_block(engine):
    """A block that returns its input unchanged."""
    step = engine.model.stacks["main"][0]
    step.forward_aux = lambda x, **kw: (x, {}, 0.0)


def half_batch(engine):
    """Half of the batch left out: its rows are the mean of the rest."""
    infer = engine.infer

    def broken(batch, cut, version):
        tokens = batch["tokens"]
        keep = (tokens.shape[0] + 1) // 2
        logits, act_bytes = infer({"tokens": tokens[:keep]}, cut, version)
        rest = logits.mean(dim=0, keepdim=True).expand(tokens.shape[0] - keep, *logits.shape[1:])
        return torch.cat([logits, rest]), act_bytes * tokens.shape[0] // keep
    engine.infer = broken


def altered_token(engine, monkeypatch):
    """A token altered where it is produced: at each batch's first position
    another entry of the vocabulary becomes the largest logit."""
    from repro_torch.core import partition

    run_tail = partition.run_tail

    def broken(*args, **kw):
        logits = run_tail(*args, **kw)
        top = logits[:, 0].amax(dim=-1)
        logits[:, 0, 1] = top + 1.0
        return logits
    monkeypatch.setattr(partition, "run_tail", broken)


def _run(cell, seed, break_path=None):
    torch.set_num_threads(2)
    config_name, mix_name = CELLS[cell]
    return harness.run_cell(cell, seed, 0.2, False, device="cpu", setup_t0=time.time(),
                            config=small_config(config_name), mix=small_mix(mix_name),
                            override=True, break_path=break_path, log=lambda s: None)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    res = _run(cell, 2 ** 31 + 11)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ("skip_block", "half_batch", "altered_token"))
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    plant = {"skip_block": skip_block, "half_batch": half_batch,
             "altered_token": lambda e: altered_token(e, monkeypatch)}[fault]
    res = _run(cell, 2 ** 31 + 11, plant)
    assert not res["correct"], res["checks"]


def test_traced_run_without_device_time_fails():
    """The traced path runs to its end on the CPU, where the profiler records
    no device kernel: the run fails rather than report a CPU number."""
    config_name, mix_name = CELLS["starcoder2-3b.split-w8"]
    with pytest.raises(RuntimeError, match="no device kernel"):
        harness.run_cell("starcoder2-3b.split-w8", 5, 0.1, True, device="cpu",
                         setup_t0=time.time(), config=small_config(config_name),
                         mix=small_mix(mix_name), override=True, log=lambda s: None)
