"""The fleet engines over the padded ragged layout: the whole epoch as
(devices,)-array ops (port of ``repro.sim.megafleet``).

``fleet.simulate`` walks a per-device Python loop over Lindley FIFOs
(``engine="loop"``, the parity oracle). The other two engines turn the
epoch into fused array programs over a *padded ragged layout*: each
epoch's per-device arrivals (counts c_d, max C = counts.max()) become an
(n, C) matrix of sorted arrival offsets, padded past each device's count
with a sentinel that sorts last; the Lindley recursion C_k = max(A_k,
C_{k-1}) + s then runs as a row-wise running max (``lindley_core``),
identical elementwise to the loop's 1-D recursion, so the valid prefix
of every row is bit-equal to what the loop computes.

- ``"vectorized"``: numpy, one ``lindley_core`` call per epoch.
  Bit-identical to the loop: a single ``uniform(size=counts.sum())``
  draw consumes the world-rng stream exactly like the loop's per-device
  draws (PCG64 doubles are consumed sequentially), the padded sort
  reproduces each device's sorted offsets, and the row-major flatten
  reproduces the loop's device-order metric recording.
- ``"scan"``: ``simulate_scan``, one epoch loop whose state lives on the
  tables' device (the card unless the world was built on the CPU),
  float32, each epoch (decide -> price -> padded Lindley -> accumulate
  -> world dynamics) as torch ops on (devices,)-tensors and nothing
  copied to the host until the loop ends. The trace counts come from the
  *same* trace-rng stream as the host engines (presampled in epoch
  order) and the initial world state from the same world-rng draws, but
  per-epoch world dynamics and arrival offsets draw from a
  ``torch.Generator`` on that device, so cross-engine parity is
  statistical (same physics, same workload, different noise), not
  bitwise; the CUDA and CPU generators draw different streams, so the
  card and the CPU agree statistically too. Latency percentiles come
  from a fixed log-spaced histogram (512 bins over 1e-4..1e4 s: ~3.7%
  relative resolution); count/SLO/energy accumulators are exact.

f32 time safety: the scan carries ``free_rel`` (each device's FIFO
drain time *relative to the epoch start*) instead of absolute time, so a
100k-epoch run never hits float32's ~0.06 s resolution at t ~ 1e6 s.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.env import EnvConfig, ProfileTables
from repro_torch.sim.traces import Trace, presample_counts

# latency-histogram shape shared by the scan engine and its summary:
# log-spaced edges, geometric-midpoint percentile readout
_NBINS = 512
_LAT_LO, _LAT_HI = 1e-4, 1e4


def lindley_core(offs, free_at, head_tx_s, tail_s, offloaded, srv_wait):
    """Row-wise Lindley recursion over the padded (n, C) layout, in numpy
    or, for tensors, in torch.

    ``offs``: per-device sorted arrival times (absolute or
    epoch-relative; the recursion is shift-invariant), padded past each
    device's count with values that sort last. ``free_at``: (n,) time
    each device's FIFO drains. ``srv_wait``, added to the offloaded rows
    under ``where=``, is a scalar or an (n, 1) column. Returns ``(lat,
    done)`` both (n, C); entries past a device's count are garbage the
    caller masks out.

    numpy: the identical operations in the identical order as the loop
    engine (so results stay bit-equal to it), buffers reused: at 100k
    devices the (n, C) temporaries are the epoch's dominant cost. torch
    (the scan engine): the reference's ``jnp`` branch op for op, the
    running max as ``torch.cummax`` along the row.
    """
    n, C = offs.shape
    s = head_tx_s[:, None]
    if isinstance(offs, torch.Tensor):
        idx = torch.arange(C, device=offs.device)
        shifted = torch.maximum(offs, free_at[:, None]) - s * idx[None, :]
        start = torch.cummax(shifted, dim=1).values
        done = start + s * (idx[None, :] + 1)
        lat = done - offs + tail_s[:, None]
        lat = torch.where(offloaded[:, None], lat + srv_wait, lat)
        return lat, done
    idx = np.arange(C)
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


# --------------------------------------------------------------------------
# scan engine
# --------------------------------------------------------------------------

def _hist_percentile(hist, edges, count, q):
    """Latency quantile from the log-binned histogram: the geometric
    midpoint of the first bin whose cumulative count reaches q."""
    if count <= 0:
        return 0.0
    cum = np.cumsum(hist)
    i = int(np.searchsorted(cum, q * count))
    i = min(i, hist.size - 1)
    lo = edges[i - 1] if i > 0 else _LAT_LO / 2
    hi = edges[i] if i < edges.size else _LAT_HI
    return float(np.sqrt(lo * hi))


def simulate_scan(env_cfg: EnvConfig, tables: ProfileTables, policy,
                  trace: Trace, *, n_requests: int = 100_000,
                  seed: int = 0, fleet=None,
                  backend=None,
                  model_ids: Optional[Sequence[int]] = None):
    """One epoch loop on the tables' device: every epoch a sequence of
    (devices,)-tensor ops (decide -> price -> padded Lindley ->
    accumulate -> world dynamics), float32 throughout, its state and
    accumulators device tensors and nothing copied to the host until the
    loop ends (port of the reference's jitted ``lax.scan``).

    Workload parity with the host engines: the per-epoch arrival counts
    are presampled from the identical trace-rng stream (and copied to the
    device once, (T, n) int32), and the initial world state (bandwidth,
    transmit power) from the identical world-rng draws; only per-epoch
    dynamics noise, intra-slot arrival offsets and the policy's draws
    come from one ``torch.Generator`` on the tables' device seeded with
    ``seed``, drawn in a fixed order each epoch: policy, arrival offsets,
    bandwidth, transmit power, activity, the server's background
    arrivals. The CUDA and CPU generators draw different streams, so a
    run on the card and one on the CPU agree statistically, not bit for
    bit; two runs on one device are identical. Stationary worlds only: a
    drift ``schedule``, ``online`` adaptation and the ExecuteBackend need
    host round-trips and raise upstream in ``fleet.simulate``.

    ``fleet.shard=True`` runs the same program on the one visible device,
    so it equals ``shard=False`` bit for bit (the reference's 1-device
    mesh); sharding the device axis over several cards waits for
    ``torch.distributed`` (ROADMAP section 1, item 5). It requires a
    per-device-decomposable policy (any static registry policy);
    trainable nets read the whole fleet's observation and are rejected.

    Returns a ``fleet.SimResult`` whose ``metrics`` holds only the drop
    counter (per-request arrays never leave the device); ``summary`` is
    built from the loop's accumulators (percentiles from the log-binned
    histogram, everything else exact).
    """
    from repro_torch.core import energy as en
    from repro_torch.core import pricing
    from repro_torch.core.controller import measured_state
    from repro_torch.sim.fleet import FleetConfig, SimResult
    from repro_torch.sim.metrics import EpochLog, FleetMetrics

    fleet = fleet if fleet is not None else FleetConfig()
    cfg = env_cfg
    n = cfg.n_uavs
    lp, pw = cfg.latency, cfg.power
    slot = float(cfg.slot_seconds)
    dev = tables.device
    if getattr(policy, "trainable", False) and fleet.shard:
        raise ValueError(
            "engine='scan' with shard=True needs a per-device-"
            "decomposable policy; trainable nets read the whole fleet's "
            "observation and cannot act on a device shard")
    if fleet.shard and dev.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            "engine='scan' with shard=True over several cards is not ported "
            "yet (ROADMAP section 1, item 5, torch.distributed)")

    if model_ids is None:
        model_ids = np.arange(n, dtype=np.int32) % tables.n_models
    model_ids = np.asarray(model_ids, dtype=np.int32)

    # identical seeding scheme to the host engines
    ss = np.random.SeedSequence(seed)
    s_trace, s_world = ss.spawn(2)
    t_rng = np.random.default_rng(s_trace)
    w_rng = np.random.default_rng(s_world)
    bw0 = w_rng.uniform(lp.bw_min_bps, lp.bw_max_bps, n)
    ptx0 = w_rng.uniform(pw.p_tx_min, pw.p_tx_max, n)

    with obs.span("fleet.scan.presample"):
        counts = presample_counts(trace, t_rng, n, slot, n_requests,
                                  fleet.max_epochs)
    T = counts.shape[0]
    if T == 0:
        raise ValueError("engine='scan' presampled zero epochs; "
                         "n_requests and max_epochs must both be > 0")
    C = max(int(counts.max()), 1)
    served = int(counts.sum())

    norm_rps = fleet.load_norm_rps or (
        cfg.peak_rps if cfg.peak_rps > 0 else max(2.0 * trace.mean_rps,
                                                  1e-9))
    M, V, K = tables.n_models, tables.n_versions, tables.n_cuts
    edges = np.geomspace(_LAT_LO, _LAT_HI, _NBINS - 1)

    f32, i32 = torch.float32, torch.int32
    gen = torch.Generator(device=dev).manual_seed(seed)
    with obs.span("fleet.scan", epochs=T, devices=n, shard=fleet.shard):
        # inputs, copied to the device once
        counts_all = torch.as_tensor(counts, dtype=i32).to(dev)     # (T, n)
        epochs_all = torch.arange(T, dtype=i32, device=dev)
        mids = torch.as_tensor(model_ids, dtype=torch.long).to(dev)
        edges_t = torch.as_tensor(edges, dtype=f32).to(dev)
        col = torch.arange(C, device=dev)
        zero = torch.zeros((), dtype=f32, device=dev)
        lam = torch.full((), cfg.queue_arrival_rate, dtype=f32, device=dev)
        # the carry
        battery = torch.full((n,), pw.battery_j, dtype=f32, device=dev)
        bw = torch.as_tensor(bw0, dtype=f32).to(dev)
        p_tx = torch.as_tensor(ptx0, dtype=f32).to(dev)
        activity = torch.as_tensor(cfg.activity, dtype=f32).to(dev)[None] \
            .repeat(n, 1)
        side_q = zero.clone()
        backlog_s = zero.clone()
        free_rel = torch.zeros(n, dtype=f32, device=dev)
        obs_rate = torch.full((n,), trace.mean_rps, dtype=f32, device=dev)
        # the accumulators
        acc_i = torch.zeros(3, dtype=i32, device=dev)   # count, dropped, slo_hits
        acc_f = torch.zeros(2, dtype=f32, device=dev)   # lat_sum, e_sum
        lat_max_acc = torch.full((), -torch.inf, dtype=f32, device=dev)
        hist_lat = torch.zeros(_NBINS, dtype=i32, device=dev)
        hist_sel = torch.zeros(M * V * K, dtype=i32, device=dev)
        # per-epoch stacked outputs: O(1) scalars only (the scan-carry
        # rule), written whether the timeline is on or off, so the loop
        # runs the same ops either way; the timeline is extracted on the
        # host after the loop
        ys_f = torch.empty((5, T), dtype=f32, device=dev)  # queue, backlog, lat_sum, lat_max, e
        ys_i = torch.empty((4, T), dtype=i32, device=dev)  # dropped, slo, alive, count

        for t in range(T):
            counts_t = counts_all[t]
            cf = counts_t.to(f32)
            alive = battery > 0.0
            queue_jobs = side_q + backlog_s / lp.job_service_s
            srv_wait = queue_jobs * lp.job_service_s
            obs_queue = torch.clamp(queue_jobs, max=fleet.queue_obs_clip)
            load = torch.clamp(obs_rate / norm_rps, 0.0, 1.0)

            # 1) decide from measured state (same sensors as the host loop)
            state = measured_state(cfg, tables, battery_j=battery,
                                   bandwidth=bw, p_tx=p_tx,
                                   queue_jobs=obs_queue, load=load,
                                   model_id=mids, activity=activity,
                                   t=epochs_all[t])
            actions = policy.act(state, gen)

            # 2) price under the same view the AnalyticalBackend builds
            view = pricing.StateView(model_id=mids, bandwidth=bw, p_tx=p_tx,
                                     queue=zero, load=zero)
            pr = pricing.price_actions(cfg, tables, view, actions, xp=torch)

            # 3) padded-ragged Lindley in epoch-relative time
            u = torch.rand((n, C), generator=gen, device=dev) * slot
            validm = col[None, :] < counts_t[:, None]
            offs = torch.sort(torch.where(validm, u, 2.0 * slot), dim=1).values
            lat, done = lindley_core(offs, free_rel, pr.head_s + pr.tx_s,
                                     pr.tail_s, pr.offloaded, srv_wait)
            upd = alive & (counts_t > 0)
            last = torch.gather(done, 1, torch.clamp(counts_t - 1, min=0)
                                .long()[:, None])[:, 0]
            free_rel = torch.where(upd, last, free_rel)
            # shift the time origin to the next epoch; anything already
            # drained clamps to "free now" (f32-safe over any horizon)
            free_rel = torch.clamp(free_rel - slot, min=0.0)

            sel = validm & alive[:, None]
            slo_hits = (sel & (lat <= fleet.slo_s)).sum(dtype=i32)
            dropped_t = torch.where(alive, 0, counts_t).sum(dtype=i32)
            count_t = torch.where(alive, counts_t, 0).sum(dtype=i32)
            lat_sum = torch.where(sel, lat, 0.0).sum()
            lat_max = torch.where(sel, lat, -torch.inf).amax()
            e_sum = torch.where(alive, cf * pr.energy_j, 0.0).sum()
            # histograms: integer adds into fixed-size zeros (deterministic)
            bins = torch.clamp(torch.searchsorted(edges_t, lat), 0, _NBINS - 1)
            hist_lat.index_add_(0, bins.reshape(-1), sel.reshape(-1).to(i32))
            flat = (mids * V + actions[:, 0]) * K + actions[:, 1]
            hist_sel.index_add_(0, flat, torch.where(alive, counts_t, 0))
            tail_in = torch.where(upd & pr.offloaded, cf * pr.tail_s, 0.0).sum()

            # 4) world dynamics (mirrors the host loop, the device's noise)
            kin = en.kinetic_power(pw, activity[:, 0], activity[:, 1],
                                   activity[:, 2])
            drain = torch.where(alive, kin * slot + cf * pr.energy_j, 0.0)
            battery = torch.clamp(battery - drain, min=0.0)
            bw = torch.clamp(bw * torch.exp(torch.randn(n, generator=gen, device=dev)
                                            * 0.15), lp.bw_min_bps, lp.bw_max_bps)
            p_tx = torch.clamp(p_tx + torch.randn(n, generator=gen, device=dev) * 0.05,
                               pw.p_tx_min, pw.p_tx_max)
            activity = torch.clamp(activity + torch.randn((n, 3), generator=gen, device=dev)
                                   * cfg.activity_jitter, 0.0, 1.0)
            activity = activity / torch.clamp(activity.sum(-1, keepdim=True), min=1.0)
            side_q = torch.clamp(side_q + torch.poisson(lam, generator=gen)
                                 - cfg.queue_service_per_slot, min=0.0)
            backlog_s = torch.clamp(backlog_s + tail_in - slot, min=0.0)
            obs_rate = (1.0 - fleet.ewma) * obs_rate + fleet.ewma * cf / slot

            # the reference's accumulator arithmetic, term for term
            acc_i += torch.stack([count_t - dropped_t, dropped_t, slo_hits])
            acc_f += torch.stack([lat_sum, e_sum])
            lat_max_acc = torch.maximum(lat_max_acc, lat_max)
            ys_f[:, t] = torch.stack([queue_jobs, backlog_s, lat_sum, lat_max, e_sum])
            ys_i[:, t] = torch.stack([dropped_t, slo_hits, alive.sum(dtype=i32),
                                      count_t])

        acc_i, acc_f = acc_i.cpu().numpy(), acc_f.cpu().numpy()
        lat_max_all = np.float32(lat_max_acc.cpu().numpy())
        hist = hist_lat.cpu().numpy()
        sel_hist = hist_sel.cpu().numpy().astype(np.int64).reshape(M, V, K)
        ys_f, ys_i = ys_f.cpu().numpy(), ys_i.cpu().numpy()

    count, dropped, slo_hits = (int(v) for v in acc_i)
    lat_sum, e_sum = acc_f
    duration = T * slot
    total = count + dropped
    summary = {
        "count": float(count), "unit": "s",
        "mean": float(lat_sum) / count if count else 0.0,
        "p50": _hist_percentile(hist, edges, count, 0.50),
        "p95": _hist_percentile(hist, edges, count, 0.95),
        "p99": _hist_percentile(hist, edges, count, 0.99),
        "max": float(lat_max_all) if count else 0.0,
        "slo": float(fleet.slo_s),
        "slo_attainment": slo_hits / total if total else float("nan"),
        "goodput": slo_hits / duration if duration else 0.0,
        "dropped": float(dropped),
        "energy_j": float(e_sum),
        "energy_per_request_j": float(e_sum) / count if count
        else 0.0,
        "duration_s": duration,
        "epochs": T, "requests": served,
    }

    metrics = FleetMetrics(slo_s=fleet.slo_s)
    metrics.dropped = dropped
    epoch_log = EpochLog(stride=fleet.log_stride, cap=fleet.log_cap)
    q_jobs, backlog, lsum_t, lmax_t, e_t = ys_f
    drop_t, slo_t, alive_t, srv_t = ys_i
    if fleet.record_epochs:
        epoch_log.extend_columns(
            epoch=np.arange(T), arrivals=counts.sum(axis=1),
            queue_jobs=q_jobs, backlog_s=backlog, dropped=drop_t,
            slo_hits=slo_t, alive=alive_t, regime=np.zeros(T, np.int64))
    tl = None
    if fleet.timeline:
        from repro_torch.obs.slo import SLOConfig
        from repro_torch.obs.timeline import Timeline
        tl = Timeline(slo_s=fleet.slo_s, slot_seconds=slot,
                      stride=fleet.log_stride, engine="scan")
        with obs.span("fleet.timeline"):
            tl.extend_epochs(
                epoch=np.arange(T), arrivals=counts.sum(axis=1),
                served=srv_t, dropped=drop_t, slo_hits=slo_t,
                alive=alive_t, queue_jobs=q_jobs, backlog_s=backlog,
                lat_sum=lsum_t, lat_max=lmax_t, energy_j=e_t)
            tl.finalize(SLOConfig(target=fleet.slo_target))
    return SimResult(summary=summary, metrics=metrics,
                     selection_hist=sel_hist, epochs=T, served=served,
                     duration_s=duration, cross_check=None,
                     epoch_log=epoch_log, adaptation=None, timeline=tl)
