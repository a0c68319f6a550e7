"""The share of the traced slice in which the card is idle while the host is
inside the program's ``quant.act`` spans: each idle gap is credited to the
innermost program span open at its midpoint."""
from edgebench.spans import idle_by_span


def read(rec):
    if not any(s[0] == "quant.act" for s in getattr(rec, "program", ())):
        return None
    return 100.0 * idle_by_span(rec).get("quant.act", 0.0) / rec.window_s
