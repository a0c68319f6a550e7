"""repro_torch.obs: learner diagnostics (port of the in-update part of
``repro.obs.traindiag``)."""
from repro_torch.obs.traindiag import DIAG_KEYS, approx_kl, explained_variance

__all__ = ["DIAG_KEYS", "approx_kl", "explained_variance"]
