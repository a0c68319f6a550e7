"""The whole infer's share of the card's peak over the traced slice: the
least time its matrix work could take (f32 FLOPs at the f32 peak plus int8
operations at the int8 peak, ``costs/infer.py``), summed over the slice's
infers, over the slice's wall time."""
from edgebench.costs import infer


def read(rec):
    if not rec.batches:
        return None
    ideal = sum(infer.ideal_s(rec.config, b["B"], b["S"], b["version"], rec.peaks)
                for b in rec.batches)
    return 100.0 * ideal / rec.window_s
