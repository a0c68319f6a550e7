"""Device time of the activation quantization a batch: the kernels launched
inside the program's ``quant.act`` spans (``quant/quantize.py::quantize_act``,
from every w8a8 projection and the link) in the traced slice, over its
batches."""
from edgebench.spans import per_batch_ms


def read(rec):
    return per_batch_ms(rec, "quant.act")
