"""The vectorized fleet engine: the whole epoch as (devices,)-array ops
(port of the numpy engine of ``repro.sim.megafleet``).

``fleet.simulate`` walks a per-device Python loop over Lindley FIFOs
(``engine="loop"``, the parity oracle). ``engine="vectorized"`` turns
the epoch into fused numpy programs over a *padded ragged layout*: each
epoch's per-device arrivals (counts c_d, max C = counts.max()) become an
(n, C) matrix of sorted arrival offsets, padded past each device's count
with a sentinel that sorts last; the Lindley recursion C_k = max(A_k,
C_{k-1}) + s then runs as a row-wise running max (``lindley_core``),
identical elementwise to the loop's 1-D recursion, so the valid prefix
of every row is bit-equal to what the loop computes.

Bit-identical to the loop: a single ``uniform(size=counts.sum())`` draw
consumes the world-rng stream exactly like the loop's per-device draws
(PCG64 doubles are consumed sequentially), the padded sort reproduces
each device's sorted offsets, and the row-major flatten reproduces the
loop's device-order metric recording.

The reference's third engine, a jitted ``jax.lax.scan`` over epochs
(``simulate_scan``), is not ported yet: it becomes a compiled GPU epoch
loop under the same contract.
"""
from __future__ import annotations

import numpy as np


def lindley_core(offs, free_at, head_tx_s, tail_s, offloaded, srv_wait):
    """Row-wise Lindley recursion over the padded (n, C) layout, in numpy.

    ``offs``: per-device sorted arrival times (absolute or
    epoch-relative; the recursion is shift-invariant), padded past each
    device's count with values that sort last. ``free_at``: (n,) time
    each device's FIFO drains. ``srv_wait``, added to the offloaded rows
    under ``where=``, is a scalar or an (n, 1) column. Returns ``(lat,
    done)`` both (n, C); entries past a device's count are garbage the
    caller masks out.

    The identical operations in the identical order as the loop engine
    (so results stay bit-equal to it), buffers reused: at 100k devices
    the (n, C) temporaries are the epoch's dominant cost.
    """
    n, C = offs.shape
    idx = np.arange(C)
    s = head_tx_s[:, None]
    done = np.maximum(offs, free_at[:, None])
    done -= s * idx[None, :]
    np.maximum.accumulate(done, axis=1, out=done)      # start
    done += s * (idx[None, :] + 1)
    lat = done - offs
    lat += tail_s[:, None]
    np.add(lat, srv_wait, out=lat, where=offloaded[:, None])
    return lat, done


def padded_offsets(counts, u, slot_seconds):
    """Pack a flat draw of ``counts.sum()`` uniforms into the padded
    (n, C) layout and sort each row: row d's first ``counts[d]`` entries
    are device d's sorted offsets (boolean-mask assignment fills in
    row-major order, i.e. device order: the same draws the loop engine
    would have pulled per device). Padding is ``2 * slot``: finite (no
    inf-inf NaN warnings downstream) and past every valid draw, so it
    sorts last. Returns ``(offsets, valid)``."""
    n = counts.shape[0]
    C = max(int(counts.max()), 1)
    col = np.arange(C)
    valid = col[None, :] < counts[:, None]
    pad = np.full((n, C), 2.0 * slot_seconds)
    pad[valid] = u
    pad.sort(axis=1)
    return pad, valid


def numpy_queues(counts, alive, free_at, pr, srv_wait, t_now,
                 slot_seconds, w_rng, metrics, slo_s):
    """One epoch of request flow, vectorized (engine="vectorized").

    Draws the epoch's arrival offsets in ONE ``uniform`` call (PCG64
    consumes doubles sequentially, so this is bitwise the same stream
    state as the loop's per-device draws), then runs ``lindley_core``
    over the padded layout and records metrics in the loop's
    device-major order. Mutates ``free_at`` in place; returns slo_hits.
    """
    total = int(counts.sum())
    if total == 0:
        return 0
    u = w_rng.uniform(0.0, slot_seconds, total)
    pad, valid = padded_offsets(counts, u, slot_seconds)
    pad += t_now          # == t_now + sort(u): the loop's exact values
    # scalar (classic) or (n,) per-device routed-server wait (cluster):
    # the latter broadcasts as a column over the (n, C) layout
    sw = srv_wait[:, None] if np.ndim(srv_wait) else srv_wait
    lat, done = lindley_core(pad, free_at, pr.head_s + pr.tx_s,
                             pr.tail_s, pr.offloaded, sw)
    upd = alive & (counts > 0)
    last = np.take_along_axis(done, np.maximum(counts - 1, 0)[:, None],
                              axis=1)[:, 0]
    free_at[upd] = last[upd]
    sel = valid & alive[:, None]
    lats = lat[sel]
    if lats.size == 0:
        return 0
    n = counts.shape[0]
    energies = np.broadcast_to(pr.energy_j[:, None], lat.shape)[sel]
    devs = np.broadcast_to(np.arange(n)[:, None], lat.shape)[sel]
    metrics.record(lats, energies, device=devs)
    return int(np.sum(lats <= slo_s))
