"""The reference of a Mamba-1 model (falcon-mamba-7b): a pre-norm selective
SSM mixer with a residual. Its four projections are plain matmuls in every
version: the port quantizes Dense leaves only, so w8 and w4 reach the head
and (w8) the link alone."""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from edgebench.reference.arith import Arith
from edgebench.reference.layers import (Spec, causal_conv, norm, norm_leaves, selective_scan,
                                        silu, softplus)


def block_leaves(m: Mapping) -> Dict[str, Spec]:
    """{leaf name inside a block: (per-layer shape, init)}, the port's names."""
    d = m["d_model"]
    di, n, k, r = m["ssm_expand"] * d, m["ssm_state"], m["ssm_conv"], m["resolved_dt_rank"]
    return {**norm_leaves(m, "norm"),
            "ssm/in_proj": ((d, 2 * di), ("fan_in",)),
            "ssm/conv_w": ((k, di), ("normal", 0.1)),
            "ssm/conv_b": ((di,), ("normal", 0.1)),
            "ssm/x_proj": ((di, r + 2 * n), ("fan_in",)),
            "ssm/dt_proj": ((r, di), ("fan_in",)),
            "ssm/dt_bias": ((di,), ("around", -4.6, 0.5)),
            "ssm/a_log": ((di, n), ("log_arange", 0.1)),
            "ssm/d_skip": ((di,), ("around", 1.0, 0.1)),
            "ssm/out_proj": ((di, d), ("fan_in",))}


def block(x, w: Dict[str, torch.Tensor], m: Mapping, version: str, ar: Arith):
    """Pre-norm Mamba-1 mixer with a residual. Its projections are plain
    matmuls in every version (the port quantizes Dense leaves only)."""
    di, n, r = m["ssm_expand"] * m["d_model"], m["ssm_state"], m["resolved_dt_rank"]
    h = norm(x, w, "norm")
    xz = ar.mm(h, w["ssm/in_proj"])
    xin, z = xz[..., :di], xz[..., di:]
    u = silu(causal_conv(xin, w["ssm/conv_w"], w["ssm/conv_b"]))
    xdbc = ar.mm(u, w["ssm/x_proj"])
    dt = softplus(ar.mm(xdbc[..., :r], w["ssm/dt_proj"]) + w["ssm/dt_bias"])
    Bm, Cm = xdbc[..., r:r + n], xdbc[..., r + n:]
    A = -torch.exp(w["ssm/a_log"])
    y = selective_scan(u, dt, Bm, Cm, A) + u * w["ssm/d_skip"]
    return x + ar.mm(y * silu(z), w["ssm/out_proj"])
