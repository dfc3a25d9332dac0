"""The relaxed parity tier's codecs (the counterpart of
``hadoop_tpu/parallel/lowp``): only the per-group int8 codec and the MoE
expert payload round trip are ported, for the serving weight plane, and
the numpy half of the A-B guard (``lowp/guard.py``)."""

from hadoop_tpu_torch.parallel.lowp.quant import (WIRE_CODECS,
                                                  dequantize_array,
                                                  moe_combine_quantized,
                                                  moe_dispatch_quantized,
                                                  quantize_array)

__all__ = ["WIRE_CODECS", "quantize_array", "dequantize_array",
           "moe_dispatch_quantized", "moe_combine_quantized"]
