"""Per-update learner health for A2C and PPO (port of
``repro.obs.traindiag``).

In-update helpers, pure functions of tensors the update already
computes:

- **explained_var**: 1 - Var[R - V]/Var[R]; 0 means the critic is a
  constant, 1 a perfect fit, negative worse than predicting the mean.
  Variances are population variances (ddof 0), as ``jnp.var``.
- **approx_kl**: mean(logp_old - logp_new) over the update's batch.

``DIAG_KEYS`` names the per-update series a diagnosed training history
carries. ``TrainDiag`` is the host-side columnar view over a finished
history (numpy) and ``check_health`` its advisory lints.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

DIAG_KEYS = ("entropy", "approx_kl", "grad_norm", "explained_var",
             "adv_mean", "adv_std")


def explained_variance(returns: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """1 - Var[R - V] / Var[R]; 0 when the return batch is constant."""
    var_r = torch.var(returns, correction=0)
    ev = 1.0 - torch.var(returns - values, correction=0) / (var_r + 1e-12)
    return torch.where(var_r > 0.0, ev, torch.zeros_like(ev))


def approx_kl(logp_old: torch.Tensor, logp_new: torch.Tensor) -> torch.Tensor:
    """mean(logp_old - logp_new): the first-order KL(old || new) estimate."""
    return torch.mean(logp_old - logp_new)


# --------------------------------------------------------------------------
# host-side accumulator / report
# --------------------------------------------------------------------------

class TrainDiag:
    """Columnar per-update diagnostics view over a training history.

    ``history`` is the list of float dicts ``a2c.train``/``ppo.train``
    return (one per update). Columns are typed numpy arrays; keys a run
    didn't record are simply absent.
    """

    def __init__(self, columns: Dict[str, np.ndarray]):
        self._cols = dict(columns)

    @classmethod
    def from_history(cls, history: List[Dict]) -> "TrainDiag":
        if not history:
            return cls({})
        keys = [k for k in history[0] if isinstance(history[0][k],
                                                    (int, float))]
        return cls({k: np.asarray([h.get(k, np.nan) for h in history],
                                  np.float64) for k in keys})

    @property
    def updates(self) -> int:
        return len(next(iter(self._cols.values()))) if self._cols else 0

    @property
    def keys(self) -> List[str]:
        return [k for k in DIAG_KEYS if k in self._cols]

    def column(self, key: str) -> np.ndarray:
        return self._cols[key]

    def __contains__(self, key: str) -> bool:
        return key in self._cols

    def summary(self) -> Dict:
        """First/last/min/max per diagnostic — the scalar slice for
        reports and smoke assertions."""
        out: Dict = {"updates": self.updates}
        for k in self.keys:
            c = self._cols[k]
            ok = c[~np.isnan(c)]
            if ok.size == 0:
                continue
            out[k] = {"first": float(ok[0]), "last": float(ok[-1]),
                      "min": float(ok.min()), "max": float(ok.max())}
        return out

    def to_json(self) -> Dict:
        return {"updates": self.updates,
                "series": {k: [None if np.isnan(v) else round(float(v), 6)
                               for v in self._cols[k]]
                           for k in self.keys},
                "summary": self.summary()}


def check_health(diag: "TrainDiag", *,
                 kl_limit: float = 1.0,
                 entropy_floor: float = 1e-4) -> List[str]:
    """Cheap post-hoc lints over a finished run: returns human-readable
    warnings (empty = clean). Advisory only — nothing gates on these."""
    warnings: List[str] = []
    if "approx_kl" in diag:
        kl = diag.column("approx_kl")
        bad = np.abs(kl[~np.isnan(kl)])
        if bad.size and bad.max() > kl_limit:
            warnings.append(
                f"approx_kl peaked at {bad.max():.3f} (> {kl_limit}): "
                "destructively large policy steps")
    if "entropy" in diag:
        ent = diag.column("entropy")
        ok = ent[~np.isnan(ent)]
        if ok.size and ok[-1] < entropy_floor:
            warnings.append(
                f"final entropy {ok[-1]:.2e} < {entropy_floor}: policy "
                "collapsed to a deterministic arm")
    if "explained_var" in diag:
        ev = diag.column("explained_var")
        ok = ev[~np.isnan(ev)]
        if ok.size and ok[-1] < 0.0:
            warnings.append(
                f"final explained variance {ok[-1]:+.3f} < 0: the critic "
                "predicts worse than the return mean")
    return warnings
