"""repro_torch.quant: quantized model versions (bf16 / w8 / w4) behind the
EdgeRL (version, cut) action space."""
from repro_torch.quant.quantize import (DENSE_WEIGHTS, QTensor, quantize,
                                        quantize_act, quantize_tree)
from repro_torch.quant.versions import (DEFAULT_VERSIONS, QuantVersion,
                                        accuracy_proxy, build_version_params,
                                        get_version, list_versions,
                                        relative_quant_error)

__all__ = ["DENSE_WEIGHTS", "QTensor", "quantize", "quantize_act",
           "quantize_tree", "DEFAULT_VERSIONS", "QuantVersion",
           "build_version_params", "get_version", "list_versions",
           "relative_quant_error", "accuracy_proxy"]
