"""Single source of truth for the per-request cost model (Eqs. 1-5, 9-11);
port of ``repro.core.pricing``.

Every consumer of the paper's physics prices through one function,

    price_actions(cfg, tables, view, actions, xp=...) -> PricingBreakdown

written against a namespace ``xp`` that is ``torch`` (the env, the A2C
rollouts and the greedy oracle, on the card or the CPU) or ``numpy`` (the
reference's fleet-simulator path). The few calls where the two namespaces
differ go through the helpers below: a Python-scalar bound (``xp.maximum``
takes no scalar in torch), conversions onto the tables' dtype and device,
and a per-server gather for batched queues. Python-float parameters
never promote the float32 tables, in either namespace.

Formula inventory (no per-request latency/energy math lives elsewhere):
  Eq. 1  E_comp = P_comp * T_local                (compute_energy)
  Eq. 2  E_trans = P_tx * 8 D / B                 (transmit_energy)
  Eq. 4  T_remote = queue * t_job + tail / F_srv  (remote_time)
  Eq. 5  T = T_local + T_trans + T_remote         (price_actions)
  Eq. 9-11 + stability score                      (*_score helpers)

Leading axes: per-device arrays are (..., n) and the classic shared queue
is (...,), so one call prices a batch of env states (the A2C rollout's
environments) or a grid of candidate actions (the greedy oracle).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class StateView:
    """The slice of world state pricing needs. Per-device arrays are (n,),
    ``queue`` is the shared server queue depth (jobs) and ``load`` the
    offered-load fraction of ``cfg.peak_rps`` in [0, 1].

    Cluster mode (actions carry a server column): ``queue`` becomes the
    per-server depth (S,), and the optional per-server fields override
    the nominal service/link arrays derived from ``cfg.cluster``; left
    None they pass through to the nominal operating point."""
    model_id: object
    bandwidth: object
    p_tx: object
    queue: object
    load: object
    srv_flops: object = None       # (S,) effective tail FLOP/s
    srv_service_s: object = None   # (S,) background-job service seconds
    link_scale: object = None      # (n, S) bandwidth multiplier
    link_rtt_s: object = None      # (n, S) per-transfer delay, seconds


def view_from_state(state) -> StateView:
    """Project an env/measured state dict onto the pricing inputs."""
    return StateView(model_id=state["model_id"], bandwidth=state["bandwidth"],
                     p_tx=state["p_tx"], queue=state["queue"],
                     load=state["task"])


@dataclasses.dataclass(frozen=True)
class PricingBreakdown:
    """Per-device per-request costs and derived scores for one action set.

    Times are seconds, energy joules, bytes per request. ``queue_s`` is
    the Eq. 4 server wait as seen by the view's queue, gated on
    ``offloaded`` (a terminal cut never visits the server queue).
    ``wire_bytes`` includes the weight-ship amortization surcharge,
    ``act_bytes`` is the raw cut activation (what an executed split must
    measure). Scores are the paper's Eqs. 9-11 plus the stability score
    of ``service_s`` (head + link) against the offered load."""
    head_s: object
    tx_s: object
    tail_s: object
    queue_s: object
    t_total: object
    energy_j: object
    act_bytes: object
    wire_bytes: object
    offloaded: object
    t_full_local: object
    e_full_local: object
    service_s: object
    acc_score: object
    lat_score: object
    energy_score: object
    stab_score: object


# --------------------------------------------------------------------------
# the calls where numpy and torch differ
# --------------------------------------------------------------------------

def _floor(x, lo: float, xp):
    """max(x, lo) for a Python-float bound: ``clip`` takes one in both
    namespaces (torch's ``maximum`` takes tensors only)."""
    return xp.clip(x, lo, None)


def _as(x, like, xp, dtype=None):
    """``x`` as an array of ``xp`` beside ``like``: on its device (torch),
    in ``dtype`` where given."""
    if xp is torch:
        return torch.as_tensor(x, dtype=dtype or torch.float32, device=like.device)
    return np.asarray(x) if dtype is None else np.asarray(x, dtype=dtype)


def _take_last(q, idx, xp):
    """q[..., idx] per leading index: the chosen server's entry of a
    per-server queue, (S,) or batched (..., S)."""
    if q.ndim <= 1:
        return q[idx] if q.ndim else q
    if xp is torch:
        return torch.gather(q, -1, idx.long())
    return np.take_along_axis(q, idx, -1)


def _sigmoid(z, xp):
    # clip keeps numpy from overflow-warning on exp of large |z|
    z = xp.clip(z, -60.0, 60.0)
    return 1.0 / (1.0 + xp.exp(-z))


def local_time(lp, head_flops, xp=torch):
    """Eq. 5 head term: T_local = head / F_dev."""
    return head_flops / lp.device_flops


def transmit_time(bandwidth_bps, n_bytes, xp=torch):
    """Eq. 5 link term: T_trans = 8 D / B."""
    return (n_bytes * 8.0) / _floor(bandwidth_bps, 1.0, xp)


def remote_time(lp, tail_flops, queue_len, xp=torch):
    """Eq. 4: T_remote = T_queue + T_comp(tail)."""
    return queue_len * lp.job_service_s + tail_flops / lp.server_flops


def total_time(lp, head_flops, tail_flops, n_bytes, bandwidth_bps,
               queue_len, xp=torch):
    """Eq. 5 (ungated; ``price_actions`` gates the queue on offload)."""
    return (local_time(lp, head_flops, xp)
            + transmit_time(bandwidth_bps, n_bytes, xp)
            + remote_time(lp, tail_flops, queue_len, xp))


def compute_energy(p, t_local_s, xp=torch):
    """Eq. 1: E_comp = P_comp * T_local."""
    return p.p_compute * t_local_s


def transmit_energy(p_tx_w, bandwidth_bps, n_bytes, xp=torch):
    """Eq. 2: E_trans = beta_k(B) * D, with beta = P_tx / throughput."""
    return p_tx_w * (n_bytes * 8.0) / _floor(bandwidth_bps, 1.0, xp)


def accuracy_score(w, acc, xp=torch):
    """Eq. 9."""
    return _sigmoid(w.p * (acc - w.q), xp)


def latency_score(t_total, t_all_local, xp=torch):
    """Eq. 10."""
    return 1.0 - t_total / _floor(t_all_local, 1e-9, xp)


def energy_score(e_total, e_all_local, xp=torch):
    """Eq. 11."""
    return 1.0 - e_total / _floor(e_all_local, 1e-9, xp)


def stability_score(w, utilization, xp=torch):
    """~1 while the device+link absorbs the offered load (u < 1), ~0 once
    requests queue faster than they drain (u > 1)."""
    return _sigmoid(w.p_stab * (1.0 - utilization), xp)


def numpy_tables(tables):
    """Numpy snapshot of the dense profile tables (copied to the host)."""
    def host(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    arrays = {f.name: getattr(tables, f.name)
              for f in dataclasses.fields(tables)
              if hasattr(getattr(tables, f.name), "shape")}
    return dataclasses.replace(tables, **{k: host(v) for k, v in arrays.items()})


def price_actions(cfg, tables, view: StateView, actions,
                  xp=torch) -> PricingBreakdown:
    """Price actions (..., 2) = (version j, cut index l), or (..., 3) =
    (version, cut, server) in cluster mode, for the devices in ``view``
    under ``cfg`` (EnvConfig). ``tables``' arrays must live in the ``xp``
    namespace (``numpy_tables`` snapshots them for numpy), and in torch the
    view and the actions on the tables' device.

    The server-side term (queue wait) is gated on a tail actually running
    there: a terminal cut executes entirely on-device and never visits the
    server queue.
    """
    m = view.model_id
    j, k = actions[..., 0], actions[..., 1]
    head = tables.head_flops[m, j, k]
    tail = tables.tail_flops[m, j, k]
    act_bytes = tables.cut_bytes[m, j, k]
    wire_bytes = act_bytes
    if cfg.weight_ship_slots > 0:
        # Amortized per-frame share of staging this version's tail weights
        # server-side: shipped once per decision epoch (weight_ship_slots
        # slots), spread over every frame served in that epoch.
        wire_bytes = wire_bytes + (tables.tail_weight_bytes[m, j, k]
                                   / (cfg.weight_ship_slots
                                      * cfg.frames_per_slot))
    acc = tables.acc[m, j]
    full = tables.full_flops[m, j]

    lp, pw, w = cfg.latency, cfg.power, cfg.weights
    head_s = local_time(lp, head, xp)
    offloaded = tail > 0.0
    if actions.shape[-1] == 3:
        # Cluster mode: the server column reprices the link (Eq. 2/3) and
        # the server-side queue/tail (Eq. 4) against the chosen target.
        srv = actions[..., 2]
        dev = (torch.arange(actions.shape[-2], device=tail.device) if xp is torch
               else np.arange(actions.shape[-2]))
        srv_flops, srv_service_s = view.srv_flops, view.srv_service_s
        if srv_flops is None:
            srv_flops, srv_service_s = cfg.cluster.nominal(lp, xp)
        # in the tables' dtype: a float64 per-server array would promote
        # the float32 tables
        srv_flops = _as(srv_flops, tail, xp, dtype=tail.dtype)
        srv_service_s = _as(srv_service_s, tail, xp, dtype=tail.dtype)
        link_scale = (view.link_scale if view.link_scale is not None
                      else _as(cfg.cluster.link_scale, tail, xp))
        link_rtt_s = (view.link_rtt_s if view.link_rtt_s is not None
                      else _as(cfg.cluster.link_rtt_s, tail, xp))
        bw = view.bandwidth * link_scale[dev, srv]
        tx_s = transmit_time(bw, wire_bytes, xp) + link_rtt_s[dev, srv]
        tail_s = tail / srv_flops[srv]
        q = view.queue if xp is torch else np.asarray(view.queue)
        queue_s = xp.where(offloaded, _take_last(q, srv, xp) * srv_service_s[srv], 0.0)
    else:
        bw = view.bandwidth
        tx_s = transmit_time(bw, wire_bytes, xp)
        tail_s = tail / lp.server_flops
        q = view.queue
        if getattr(q, "ndim", 0):     # a batch of shared queues: (...,) -> (..., 1)
            q = q[..., None]
        queue_s = xp.where(offloaded, q * lp.job_service_s, 0.0)
    t_total = head_s + tx_s + queue_s + tail_s

    energy_j = (compute_energy(pw, head_s, xp)
                + transmit_energy(view.p_tx, bw, wire_bytes, xp))
    t_full_local = local_time(lp, full, xp)
    e_full_local = compute_energy(pw, t_full_local, xp)

    # per-request service time the device serializes: head compute + link
    service_s = head_s + tx_s
    util = view.load * cfg.peak_rps * service_s
    return PricingBreakdown(
        head_s=head_s, tx_s=tx_s, tail_s=tail_s, queue_s=queue_s,
        t_total=t_total, energy_j=energy_j, act_bytes=act_bytes,
        wire_bytes=wire_bytes, offloaded=offloaded,
        t_full_local=t_full_local, e_full_local=e_full_local,
        service_s=service_s,
        acc_score=accuracy_score(w, acc, xp),
        lat_score=latency_score(t_total, t_full_local, xp),
        energy_score=energy_score(energy_j, e_full_local, xp),
        stab_score=stability_score(w, util, xp))
