"""Per-layer metric readers, one file each, found by the metric's name in
BENCHMARK.json: a name ``<quantity>`` or ``<quantity>.<cell>`` is read by
``<quantity>.py`` (one quantity split by the end-to-end metric it moves in
each cell). Each has ``read(rec: edgebench.trace.Record) -> float | None``:
None where the traced slice holds nothing for it to read."""
import importlib


def reader(name: str):
    """The ``read`` function of the metric ``name``."""
    return importlib.import_module(f"{__name__}.{name.split('.')[0]}").read
