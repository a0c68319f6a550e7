"""The share of the traced slice in which no kernel ran on the card."""
from edgebench.trace import busy_s


def read(rec):
    return 100.0 * (1.0 - busy_s(rec) / rec.window_s)
