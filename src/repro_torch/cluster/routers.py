"""Router baselines for the cluster action space (version, cut, server)
(port of ``repro.cluster.routers``, in torch).

Each router fixes the *server* column with a classic dispatch rule and
lets the greedy (V, K) grid pick the execution profile under that
target, so router comparisons isolate the routing decision itself (what
A2C/PPO must learn end-to-end) from profile selection:

- ``round_robin``          cycle devices across servers each epoch
- ``join_shortest_queue``  every device targets the min-depth server
- ``local_only``           lightweight version, terminal cut, server 0:
                           the never-offload floor

JSQ ranks servers by *job count*; on a heterogeneous pool (hetero-4) a
quarter-rate tier with a short queue looks cheap even though its
effective wait is long: exactly the misread a learned router can beat by
pricing depth x service rate per target.

Registered into the ``repro_torch.policies`` registry (the canonical
names above) on ``import repro_torch.policies``; building one against a
non-cluster env raises ValueError. Actions are int64 tensors on the
tables' device.
"""
from __future__ import annotations

import torch

from repro_torch.core import pricing
from repro_torch.policies.base import PolicySpec, register
from repro_torch.policies.static import StaticPolicy


def _best_pair_given_server(cfg, tables, state, srv):
    """Per-UAV reward argmax over (version, cut) with the server column
    pinned at ``srv`` (n,) int64: greedy_oracle's scoring restricted to
    the router's chosen target, the (V, K) grid priced in one batched
    call of the pricing core (the grid is a leading axis of the
    actions)."""
    n, dev = cfg.n_uavs, tables.device
    V, K = tables.n_versions, tables.n_cuts
    w = cfg.weights
    jj, kk = torch.meshgrid(torch.arange(V, device=dev), torch.arange(K, device=dev),
                            indexing="ij")
    pairs = torch.stack([jj.reshape(-1), kk.reshape(-1)], -1)       # (VK, 2)
    actions = torch.cat([pairs[:, None, :].expand(V * K, n, 2),
                         srv[None, :, None].expand(V * K, n, 1)], -1)
    br = pricing.price_actions(cfg, tables, pricing.view_from_state(state),
                               actions, xp=torch)
    valid = tables.version_valid[state["model_id"][None, :], pairs[:, :1]]   # (VK, n)
    s = (w.w_acc * br.acc_score + w.w_lat * br.lat_score
         + w.w_energy * br.energy_score + w.w_stab * br.stab_score)
    scores = torch.where(valid > 0, s, torch.full_like(s, -torch.inf))
    best = torch.argmax(scores, dim=0)                               # (n,)
    return torch.cat([pairs[best], srv[:, None]], -1)


def round_robin(cfg, tables, state, generator=None):
    """Cycle devices over servers, rotating one slot per epoch so the
    assignment is load-balanced in time as well as across devices."""
    n, S, dev = cfg.n_uavs, cfg.cluster.n_servers, tables.device
    t = torch.as_tensor(state["t"], device=dev).long()
    srv = (torch.arange(n, device=dev) + t) % S
    return _best_pair_given_server(cfg, tables, state, srv)


def join_shortest_queue(cfg, tables, state, generator=None):
    """Every device targets the server with the fewest queued jobs:
    depth-blind to heterogeneous service rates, by construction."""
    dev = tables.device
    q = torch.broadcast_to(torch.as_tensor(state["queue"], device=dev),
                           (cfg.cluster.n_servers,))
    srv = torch.argmin(q).expand(cfg.n_uavs)
    return _best_pair_given_server(cfg, tables, state, srv)


def local_only(cfg, tables, state, generator=None):
    """Never offload: lightweight version, terminal cut, server 0 (the
    server column is vestigial: no tail ever reaches it)."""
    n, dev = cfg.n_uavs, tables.device
    return torch.stack([torch.zeros(n, dtype=torch.long, device=dev),
                        torch.full((n,), tables.n_cuts - 1, dtype=torch.long, device=dev),
                        torch.zeros(n, dtype=torch.long, device=dev)], -1)


def _router(name: str, fn, description: str) -> PolicySpec:
    def factory(env_cfg, tables, **kw):
        if env_cfg.cluster is None:
            raise ValueError(
                f"router policy {name!r} needs a cluster-mode env "
                "(EnvConfig.cluster is set by scenarios with a server "
                "pool, e.g. --scenario edge-cluster)")
        return StaticPolicy(env_cfg, tables, fn)

    return register(PolicySpec(name=name, factory=factory,
                               trainable=False, description=description,
                               needs_cluster=True))


_router("round_robin", round_robin,
        "rotate devices across servers; greedy (version, cut) per target")
_router("join_shortest_queue", join_shortest_queue,
        "all devices target the min-depth server (job-count JSQ)")
_router("local_only", local_only,
        "never offload: light version, terminal cut (cluster floor)")
