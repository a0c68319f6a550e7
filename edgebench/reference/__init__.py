"""The plain reference: the split forward of the sampled requests in plain
PyTorch, f32 with TF32 off, layer by layer, each layer's weights remade from
(seed, leaf path, layer) by ``edgebench.weights`` and freed before the next.

It imports nothing of the port. It reads only the configuration file, the
seed and the requests (token ids, version, cut); it works out the quantized
weights and the activation codes again itself (``arith``). Each
architecture's layers are a module of this package, which the configuration
names under ``reference``.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import torch

from edgebench import weights
from edgebench.reference.arith import Arith
from edgebench.reference.layers import norm


def logits(config: Mapping, seed: int, requests: Sequence[Dict], device,
           control=None) -> List[torch.Tensor]:
    """requests: [{"tokens": (S,) int64 on ``device``, "version": "bf16" | "w8"
    | "w4", "cut": layers run before the link}] -> [(S, vocab) f32 logits],
    in order. Requests of one version run as one batch, right-padded to the
    longest: every layer is causal and every quantization is per row, so the
    padding changes no real position. ``control`` (a name of
    ``arith.CONTROLS``; True for ``"control"``) computes the same in that
    control's arithmetic."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ar = Arith("control" if control is True else control)
    m = config["model"]
    block = weights.arch(config).block
    groups: Dict[str, List[int]] = {}
    for i, r in enumerate(requests):
        groups.setdefault(r["version"], []).append(i)
    with torch.inference_mode():
        embed = weights.top_weight(config, seed, "tok_embed", device)
        xs, cuts = {}, {}
        for v, idx in groups.items():
            S = max(requests[i]["tokens"].shape[0] for i in idx)
            tok = torch.zeros((len(idx), S), dtype=torch.long, device=device)
            for row, i in enumerate(idx):
                t = requests[i]["tokens"]
                tok[row, :t.shape[0]] = t
            xs[v] = embed[tok]
            cuts[v] = torch.tensor([requests[i]["cut"] for i in idx], device=device)
        del embed
        for layer in range(m["n_layers"]):
            w = weights.layer_weights(config, seed, layer, device)
            for v in xs:
                x = block(xs[v], w, m, v, ar)
                if v == "w8":
                    at_cut = cuts[v] == layer + 1
                    if bool(at_cut.any()):
                        x[at_cut] = ar.link(x[at_cut])
                xs[v] = x
            del w
        top = {p: weights.top_weight(config, seed, p, device)
               for p in weights.top_leaves(config) if p != "tok_embed"}
        head = top.get("lm_head")
        if head is None:
            head = weights.top_weight(config, seed, "tok_embed", device).T
        out: List[torch.Tensor] = [None] * len(requests)
        for v, idx in groups.items():
            h = norm(xs[v], top, "final_norm")
            lg = ar.proj(h, head, v) if "lm_head" in top else ar.mm(h, head)
            for row, i in enumerate(idx):
                out[i] = lg[row, :requests[i]["tokens"].shape[0]]
        return out
