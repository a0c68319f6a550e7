"""Device time of the w4 weights' dequantization a w4 batch: the kernels
launched inside the program's ``quant.dequant`` spans
(``quant/quantize.py::QTensor.dequantize``, the w4 head's) in the traced
slice, over its w4 batches."""
from edgebench.spans import per_batch_ms


def read(rec):
    return per_batch_ms(rec, "quant.dequant", "w4")
