"""Dense (identity) compressor, the last entry of the format priority
list. Counterpart of ``compressed_tensors_tpu/compressors/dense.py``."""

from __future__ import annotations

from compressed_tensors_tpu_torch.compressors.base import (
    BaseCompressor,
    TensorStateDict,
)
from compressed_tensors_tpu_torch.config import CompressionFormat
from compressed_tensors_tpu_torch.quantization import QuantizationScheme

__all__ = ["DenseCompressor"]


@BaseCompressor.register(name=CompressionFormat.dense.value)
class DenseCompressor(BaseCompressor):
    @classmethod
    def compression_param_names(cls, scheme: QuantizationScheme) -> tuple[str, ...]:
        return ("weight",)

    @classmethod
    def decompress(
        cls, state_dict: TensorStateDict, scheme: QuantizationScheme
    ) -> TensorStateDict:
        return dict(state_dict)

    @classmethod
    def can_compress(cls, module_type: str, scheme: QuantizationScheme) -> bool:
        return True
