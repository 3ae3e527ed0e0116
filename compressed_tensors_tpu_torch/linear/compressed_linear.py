"""Deprecated stub: ``CompressedLinear`` raises, as in the JAX package."""

__all__ = ["CompressedLinear"]


class CompressedLinear:
    """No longer supported. Run-compressed execution is the engine default:
    see ``compressed_tensors_tpu_torch.ops.linear.quantized_matmul``."""

    @classmethod
    def from_linear(cls, *args, **kwargs):
        raise NotImplementedError(
            "`CompressedLinear` is no longer supported; run-compressed "
            "inference is the engine default (ops.linear.quantized_matmul / "
            "models.load_llama_params)")

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "`CompressedLinear` is no longer supported; use "
            "ops.linear.QuantizedTensor + quantized_matmul")
