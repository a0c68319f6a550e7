"""Mixture-of-Experts layer (port of ``repro.models.moe``): top-k routing,
capacity-based dispatch, shared experts, the Switch load-balance aux loss.

The sequence is dispatched in chunks of ``cfg.moe_chunk`` tokens (one chunk
when the length is no multiple of it). Each chunk routes its tokens to
``top_k`` experts; a (token, slot) takes the next free place of its
expert's buffer of C places, in token-major, slot-minor order, and is
dropped when the buffer is full. Every expert runs at its C places, empty
ones included, as the reference computes it. Two dispatches give the same
function: ``"einsum"`` (the one-hot dispatch and combine tensors of GShard)
and ``"gather"`` (a scatter-add into the expert buffers and a gather back).
The expert products are plain ``torch.einsum``s: the reference computes
them outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import sharded
from repro_torch.models.layers import dense

MOE_CHUNK = 1024   # tokens per dispatch chunk when cfg.moe_chunk is 0


def _capacity(chunk: int, cfg: ModelConfig) -> int:
    """Places per expert for a chunk of ``chunk`` tokens: the share of its
    top_k * chunk slots times the capacity factor, rounded up to a multiple
    of 8, at most ``chunk`` and at least ``top_k``."""
    c = int(chunk * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(cfg.top_k, min(chunk, -(-c // 8) * 8))


def _route(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor):
    """x (B, T, d) -> (top_p, top_e, pos, keep, sel, aux): the renormalised
    top-k probabilities and experts (B, T, K), sorted so that slot 0 holds
    the top-1 expert; each (token, slot)'s place in its expert's buffer (f32,
    B, T, K) and whether it fits; the one-hot experts (B, T, K, E); the
    Switch aux loss E * sum(mean prob * mean assignment) / K."""
    B, T, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = _capacity(T, cfg)
    probs = torch.softmax(dense(x.to(torch.float32), router.to(torch.float32)), dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1, sorted=True)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    sel = F.one_hot(top_e, E).to(torch.float32)                  # (B, T, K, E)
    # exclusive cumsum over each batch row's token-major, slot-minor T * K
    flat = sel.reshape(B, T * K, E)
    pos_in_e = (torch.cumsum(flat, dim=1) - flat).reshape(B, T, K, E)
    pos = (pos_in_e * sel).sum(-1)                               # (B, T, K)
    keep = (pos < C) & (sel.sum(-1) > 0)
    me = probs.mean(dim=(0, 1))                                  # (E,)
    ce = sel.sum(2).mean(dim=(0, 1))                             # (E,)
    aux = E * (me * ce).sum() / K
    return top_p, top_e, pos, keep, sel, aux


def _route_sums(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor):
    """The sums over x's batch and tokens of the router's probabilities and
    of its top-k assignments (E,) each: the aux loss's means times B * T,
    which add up over batch shards where the means do not."""
    probs = torch.softmax(dense(x.to(torch.float32), router.to(torch.float32)), dim=-1)
    top_e = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)[1]
    assigned = F.one_hot(top_e, cfg.n_experts).to(torch.float32)
    return probs.sum(dim=(0, 1)), assigned.sum(dim=(0, 1, 2))


def _experts(w_gate, w_up, w_down, xe: torch.Tensor) -> torch.Tensor:
    """xe (B, E, C, d) -> (B, E, C, d): each expert's SwiGLU at its places."""
    h = (F.silu(torch.einsum("becd,edf->becf", xe, w_gate))
         * torch.einsum("becd,edf->becf", xe, w_up))
    return torch.einsum("becf,efd->becd", h, w_down)


class MoE(nn.Module):
    """``router`` (d, E), ``w_gate`` and ``w_up`` (E, d, f), ``w_down`` (E, f,
    d) and, with ``cfg.n_shared_experts``, a ``shared`` MLP added over the
    whole sequence. ``forward(x)`` returns (y, aux) with aux already
    weighted by ``cfg.router_aux_weight``."""

    def __init__(self, cfg: ModelConfig, p: Dict[str, torch.Tensor],
                 shared: Optional[nn.Module] = None):
        super().__init__()
        self.cfg = cfg
        for name in ("router", "w_gate", "w_up", "w_down"):
            setattr(self, name, nn.Parameter(p[name], requires_grad=False))
        self.shared = shared

    def _dispatch_einsum(self, x: torch.Tensor, weights=None, e0: int = 0):
        """GShard's one-hot dispatch and combine tensors (B, T, E, C).
        ``weights`` (router, w_gate, w_up, w_down) default to the layer's;
        experts' weights of El < E experts are experts e0 .. e0 + El - 1,
        and only they run: the output is their share of the sum."""
        cfg = self.cfg
        router, w_gate, w_up, w_down = weights or (self.router, self.w_gate, self.w_up,
                                                   self.w_down)
        C = _capacity(x.shape[1], cfg)
        top_p, _, pos, keep, sel, aux = _route(cfg, router, x)
        # one_hot(pos, C) with the dropped (pos >= C) rows all zero
        places = torch.arange(C, device=x.device, dtype=pos.dtype)
        pos_oh = (pos[..., None] == places).to(torch.float32) * keep[..., None]
        # a token's K slots go to K different experts, so every (t, e, c)
        # has at most one nonzero term over k: both tensors are exact
        combine = torch.einsum("btke,btkc->btec", sel * top_p[..., None], pos_oh)
        dispatch = torch.einsum("btke,btkc->btec", sel, pos_oh)
        El = w_gate.shape[0]
        if El != cfg.n_experts:
            combine, dispatch = combine[:, :, e0:e0 + El], dispatch[:, :, e0:e0 + El]
        xe = torch.einsum("btec,btd->becd", dispatch.to(x.dtype), x)
        ye = _experts(w_gate, w_up, w_down, xe)
        return torch.einsum("btec,becd->btd", combine.to(x.dtype), ye), aux

    def _dispatch_gather(self, x: torch.Tensor):
        """A scatter-add into (B, E * C + 1, d) expert buffers, whose last
        row catches the dropped slots, and a gather back."""
        cfg = self.cfg
        B, T, d = x.shape
        E, K = cfg.n_experts, cfg.top_k
        C = _capacity(T, cfg)
        top_p, top_e, pos, keep, _, aux = _route(cfg, self.router, x)
        slot = torch.where(keep, top_e * C + pos.to(torch.int64), E * C)     # (B, T, K)
        b_idx = torch.arange(B, device=x.device)[:, None, None].expand_as(slot)
        vals = x[:, :, None, :].expand(B, T, K, d)
        xe_flat = x.new_zeros(B, E * C + 1, d).index_put_((b_idx, slot), vals, accumulate=True)
        ye = _experts(self.w_gate, self.w_up, self.w_down,
                      xe_flat[:, :E * C].reshape(B, E, C, d))
        ye_flat = torch.cat([ye.reshape(B, E * C, d), ye.new_zeros(B, 1, d)], dim=1)
        w = (top_p * keep).to(x.dtype)
        return (ye_flat[b_idx, slot] * w[..., None]).sum(2), aux

    def _chunk(self, S: int) -> int:
        chunk = min(self.cfg.moe_chunk or MOE_CHUNK, S)
        return chunk if S % chunk == 0 else S      # one chunk: small or odd sequences

    def _forward_sharded(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """The einsum dispatch on local shards, mesh dim by mesh dim: where x
        is split over its batch, the experts are gathered whole there; where
        the experts (dim 0) or their hidden width are split, x is whole and
        each rank runs its part of every chunk, the output a partial sum;
        else both are whole. Each rank routes every token it holds over all
        E experts. The aux loss takes its means from sums over the batch
        shards, as the unsharded layer takes them over the whole batch."""
        cfg = self.cfg
        B, S, _ = x.shape
        chunk = self._chunk(S)
        R = Replicate()
        xt, gt, dt, ot, st = [], [], [], [], []
        for px, pg in zip(x.placements, self.w_gate.placements):
            if isinstance(px, Shard) and px.dim == 0:
                lay = (px, R, R, px, Partial())
            elif isinstance(pg, Shard) and pg.dim in (0, 2):
                lay = (R, pg, Shard(0) if pg.dim == 0 else Shard(1), Partial(), R)
            else:
                lay = (R, R, R, R, R)
            for acc, p in zip((xt, gt, dt, ot, st), lay):
                acc.append(p)
        xt, gt, dt, ot, st = map(tuple, (xt, gt, dt, ot, st))
        e0 = sharded.local_slice(self.w_gate.shape, self.w_gate.device_mesh, gt)[1][0]

        def experts(xl, rl, gl, ul, dl):
            return torch.cat([self._dispatch_einsum(xc, (rl, gl, ul, dl), e0)[0]
                              for xc in xl.split(chunk, dim=1)], dim=1)

        def sums(xl, rl):
            psum, ssum = zip(*(_route_sums(cfg, rl, xc) for xc in xl.split(chunk, dim=1)))
            return torch.stack(psum), torch.stack(ssum)

        whole = (R,) * len(xt)
        y, = sharded.local_call(experts, (x, self.router, self.w_gate, self.w_up, self.w_down),
                                (xt, whole, gt, gt, dt), (ot,))
        # apart from the experts' call: split over the experts' mesh dims,
        # that call takes the router's gradient as a partial sum there,
        # which the aux loss's (the same on each of those ranks) is not
        psum, ssum = sharded.local_call(sums, (x, self.router), (xt, whole), (st, st))
        n = B * chunk
        aux = (cfg.n_experts * ((psum / n) * (ssum / n)).sum(-1) / cfg.top_k).mean()
        if self.shared is not None:
            y = y + self.shared(x)
        return y, aux * cfg.router_aux_weight

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, S, d) -> (y (B, S, d), aux). A sharded layer (DTensor
        weights) runs the einsum dispatch on local shards
        (``_forward_sharded``)."""
        cfg = self.cfg
        if sharded.is_dtensor(self.w_gate) and cfg.moe_impl != "gather":
            return self._forward_sharded(x)
        B, S, d = x.shape
        dispatch = self._dispatch_gather if cfg.moe_impl == "gather" else self._dispatch_einsum
        chunk = self._chunk(S)
        if chunk == S:
            y, aux = dispatch(x)
        else:
            ys, auxs = zip(*(dispatch(xc) for xc in x.split(chunk, dim=1)))
            y, aux = torch.cat(ys, dim=1), torch.stack(auxs).mean()
        if self.shared is not None:
            y = y + self.shared(x)
        return y, aux * cfg.router_aux_weight
