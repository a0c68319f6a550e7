"""Baseline execution-profile policies the paper implicitly compares
against: device-only, full-offload, random, and a per-step greedy oracle
(port of ``repro.core.baselines``).

The greedy oracle prices every (version, cut) pair per UAV under the
current state in one batched call of the pricing core (the grid is a
leading axis of the actions) and picks the per-UAV reward argmax. Actions
are int64 tensors on the tables' device. Every policy sizes its actions by
the state it is given (``state["model_id"]``), not by ``cfg.n_uavs``, so
a device shard of the fleet gets the rows the whole fleet's call gives
those devices (the sharded scan engine acts on shards).
"""
from __future__ import annotations

import torch

from repro_torch.core import pricing
from repro_torch.core.env import EnvConfig, ProfileTables


def _with_server(cfg: EnvConfig, actions, srv=None):
    """Append a server column when the env runs in cluster mode; static
    baselines default to server 0."""
    if cfg.cluster is None:
        return actions
    if srv is None:
        srv = torch.zeros(actions.shape[0], dtype=actions.dtype, device=actions.device)
    return torch.cat([actions, srv[:, None].to(actions.dtype)], -1)


def device_only(cfg: EnvConfig, tables: ProfileTables, state, generator=None):
    """Lightweight version, run everything locally (last cut)."""
    n, dev = state["model_id"].shape[0], tables.device
    a = torch.stack([torch.zeros(n, dtype=torch.long, device=dev),
                     torch.full((n,), tables.n_cuts - 1, dtype=torch.long, device=dev)], -1)
    return _with_server(cfg, a)


def full_offload(cfg: EnvConfig, tables: ProfileTables, state, generator=None):
    """Heavy version, cut as early as possible."""
    j = (tables.version_valid[state["model_id"]].sum(-1) - 1).long()
    return _with_server(cfg, torch.stack([j, torch.zeros_like(j)], -1))


def random_policy(cfg: EnvConfig, tables: ProfileTables, state,
                  generator: torch.Generator):
    """Uniform over each device's valid versions and all cuts (and, in
    cluster mode, servers); drawn on the generator's device."""
    n, dev = state["model_id"].shape[0], tables.device
    nv = tables.version_valid[state["model_id"]].sum(-1)

    def uniform_int(high):
        u = torch.rand(n, generator=generator, device=generator.device).to(dev)
        return torch.clamp((u * high).long(), max=torch.as_tensor(high, device=dev).long() - 1)

    a = torch.stack([uniform_int(nv), uniform_int(float(tables.n_cuts))], -1)
    if cfg.cluster is None:
        return a
    return _with_server(cfg, a, uniform_int(float(cfg.cluster.n_servers)))


def greedy_oracle(cfg: EnvConfig, tables: ProfileTables, state, generator=None):
    """Per-step per-UAV reward argmax over all (j, k), and over the server
    axis too in cluster mode."""
    n, dev = state["model_id"].shape[0], tables.device
    V, K = tables.n_versions, tables.n_cuts
    axes = [torch.arange(V, device=dev), torch.arange(K, device=dev)]
    if cfg.cluster is not None:
        axes.append(torch.arange(cfg.cluster.n_servers, device=dev))
    grids = torch.meshgrid(*axes, indexing="ij")
    cands = torch.stack([g.reshape(-1) for g in grids], -1)         # (VKS, A)
    w = cfg.weights
    actions = cands[:, None, :].expand(cands.shape[0], n, cands.shape[1])
    br = pricing.price_actions(cfg, tables, pricing.view_from_state(state),
                               actions, xp=torch)
    valid = tables.version_valid[state["model_id"][None, :], cands[:, :1]]  # (VKS, n)
    s = (w.w_acc * br.acc_score + w.w_lat * br.lat_score
         + w.w_energy * br.energy_score + w.w_stab * br.stab_score)
    scores = torch.where(valid > 0, s, torch.full_like(s, -torch.inf))
    return cands[torch.argmax(scores, dim=0)]
