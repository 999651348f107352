from repro_torch.quant.quantize import (
    QTensor, quantize_int8, dequantize, quantize_params, qmatmul_ref,
    quantized_bytes,
)

__all__ = ["QTensor", "quantize_int8", "dequantize", "quantize_params",
           "qmatmul_ref", "quantized_bytes"]
