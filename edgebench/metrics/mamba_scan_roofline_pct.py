"""``mamba_scan``'s share of its roofline bound (SFU exps or bytes) over its
launches in the traced slice: one a layer an infer."""
from edgebench.costs import mamba_scan as ms
from edgebench.costs.infer import launches
from edgebench.trace import roofline_pct


def _calls(rec):
    m = rec.config["model"]

    def per_batch(b):
        n = launches(rec.config, b["version"])["mamba_scan"]
        if not n:
            return []
        return [ms.cost(b["B"], b["S"], m["ssm_expand"] * m["d_model"], m["ssm_state"])] * n
    return per_batch


def read(rec):
    return roofline_pct(rec, ms.KERNEL, ms.NOT, _calls(rec), ms.bound_s)
