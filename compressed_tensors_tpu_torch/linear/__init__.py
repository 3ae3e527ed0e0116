"""The deprecated ``CompressedLinear`` stub (API parity): run-compressed
execution is ``ops.linear.QuantizedTensor`` + ``quantized_matmul``."""

from compressed_tensors_tpu_torch.linear.compressed_linear import (
    CompressedLinear,
)

__all__ = ["CompressedLinear"]
