"""``flash_attention``'s share of its roofline bound over its launches in the
traced slice (one a layer an infer, at the infer's B and S)."""
from edgebench.costs import flash_attention as fa
from edgebench.costs.infer import launches
from edgebench.trace import roofline_pct


def _calls(rec):
    m = rec.config["model"]

    def per_batch(b):
        n = launches(rec.config, b["version"])["flash_attention"]
        if not n:
            return []
        return [fa.cost(b["B"], b["S"], m["n_heads"], m["n_kv_heads"], m["head_dim"],
                        m["head_dim"], m["sliding_window"])] * n
    return per_batch


def read(rec):
    return roofline_pct(rec, fa.KERNEL, (), _calls(rec), fa.bound_s)
