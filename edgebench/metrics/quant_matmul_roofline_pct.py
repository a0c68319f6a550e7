"""``quant_matmul``'s share of its roofline bound over its launches in the
traced slice: each w8 infer's quantized projections at M = B x S and its
head."""
from edgebench.costs import quant_matmul as qmm
from edgebench.costs.infer import arch
from edgebench.trace import roofline_pct


def _calls(rec):
    m = rec.config["model"]
    quant, _ = arch(rec.config).projections(m)
    shapes = quant * m["n_layers"] + ([] if m["tie_embeddings"] else [(m["d_model"], m["vocab_size"])])

    def per_batch(b):
        if b["version"] != "w8":
            return []
        return [qmm.cost(b["B"] * b["S"], k, n) for k, n in shapes]
    return per_batch


def read(rec):
    return roofline_pct(rec, qmm.KERNEL, (), _calls(rec), qmm.bound_s)
