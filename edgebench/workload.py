"""The one traffic generator: it reads a mix's parameters from
``edgebench/traffic/<name>.json`` and draws every batch before the window.

A mix is served in rounds. A round is a fixed set of ``round`` batches made
from ``round_seed``: each batch size of ``batch`` the same number of times,
each version in its share of ``versions``, each of the profile's cut indices
the same number of times, and ``round`` sequence lengths, paired by fixed
permutations. The lengths come from ``seq``'s pieces, each a log-uniform
range that gives ``batches`` lengths at its evenly spaced quantiles: a body
and a longer, thinner tail.
Every run serves the same rounds; ``--seed`` orders each round and draws the
token ids, so two seeds do the same work in another order.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from edgebench.weights import leaf_seed

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


@dataclasses.dataclass
class Batch:
    index: int            # place in the run's order
    round: int
    B: int
    S: int
    version: str
    k: int                # cut index into the profile's cut points
    tokens: torch.Tensor  # (B, S) int64 on the device
    cut: Tuple[str, int] = None   # set by the decision mapping


def load_mix(name: str) -> Dict:
    path = TRAFFIC_DIR / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    mix = json.loads(path.read_text())
    if mix.get("loop") != "closed" or mix.get("clients") != 1:
        raise ValueError(f"{name}: the generator drives one closed-loop client")
    return mix


def _counts(total: int, shares: Mapping[str, float]) -> List[str]:
    """``total`` labels, each in its share; shares must divide it."""
    whole = sum(shares.values())
    out = []
    for label, share in shares.items():
        n = total * share / whole
        if abs(n - round(n)) > 1e-9:
            raise ValueError(f"round of {total} does not split into shares {dict(shares)}")
        out += [label] * int(round(n))
    return out


def seq_lengths(mix: Mapping, n: int) -> List[int]:
    """``n`` lengths: each piece's ``batches`` lengths at the quantiles
    (i + 0.5) / batches of its log-uniform range [min, max]."""
    if mix["seq"].get("dist") != "log_uniform":
        raise ValueError("seq.dist must be log_uniform")
    out = []
    for p in mix["seq"]["pieces"]:
        lo, hi, k = p["min"], p["max"], p["batches"]
        out += [int(round(lo * math.exp((i + 0.5) / k * math.log(hi / lo)))) for i in range(k)]
    if len(out) != n:
        raise ValueError(f"seq's pieces give {len(out)} lengths for a round of {n}")
    return out


def round_plan(mix: Mapping, n_cuts: int) -> List[Tuple[int, int, str, int]]:
    """The fixed round: [(B, S, version, cut index)] in plan order."""
    M = mix["round"]
    sizes = list(range(mix["batch"]["min"], mix["batch"]["max"] + 1))
    Bs = _counts(M, {str(b): 1 for b in sizes})
    vs = _counts(M, mix["versions"])
    ks = _counts(M, {str(k): 1 for k in range(n_cuts)})
    Ss = seq_lengths(mix, M)
    rng = np.random.default_rng(mix["round_seed"])
    pb, pv, pk = rng.permutation(M), rng.permutation(M), rng.permutation(M)
    return [(int(Bs[pb[i]]), Ss[i], vs[pv[i]], int(ks[pk[i]])) for i in range(M)]


def _rng(seed: int, *more: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), *more])


def schedule(mix: Mapping, seed: int, n_cuts: int, vocab: int, device,
             n_rounds: int = None) -> List[Batch]:
    """Every batch of the run, in order, its tokens on ``device``."""
    plan = round_plan(mix, n_cuts)
    n_rounds = mix["max_rounds"] if n_rounds is None else n_rounds
    order = [(r, int(j)) for r in range(n_rounds) for j in _rng(seed, r).permutation(len(plan))]
    total = sum(plan[j][0] * plan[j][1] for _, j in order)
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, "traffic/tokens", None))
    ids = torch.randint(0, vocab, (total,), generator=g, device=device, dtype=torch.int64)
    out, off = [], 0
    for i, (r, j) in enumerate(order):
        B, S, v, k = plan[j]
        out.append(Batch(i, r, B, S, v, k, ids[off:off + B * S].view(B, S)))
        off += B * S
    return out


def check_sample(batches: List[Batch], seed: int, n: int) -> Dict[int, int]:
    """{batch index: row} of the requests whose logits are compared: from
    round 0, for each version its longest batch, then batches drawn from the
    seed up to ``n``; each batch's row drawn from the seed."""
    first = [b for b in batches if b.round == 0]
    rng = _rng(seed, 2 ** 32 + 1)
    picked = []
    for v in sorted({b.version for b in first}):
        picked.append(max((b for b in first if b.version == v), key=lambda b: (b.S, b.B)).index)
    rest = [b.index for b in first if b.index not in picked]
    picked += [rest[i] for i in rng.permutation(len(rest))[:max(0, n - len(picked))]]
    return {i: int(rng.integers(batches[i].B)) for i in sorted(picked)}
