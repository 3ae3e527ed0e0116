"""Transforms (QuIP/SpinQuant-style rotations): schemas, Hadamard
construction, and the fused (offline) application to dense weights.
Counterpart of ``compressed_tensors_tpu/transform``."""

from compressed_tensors_tpu_torch.transform.schemas import (  # noqa: F401
    TransformArgs,
    TransformConfig,
    TransformLocation,
    TransformScheme,
)
from compressed_tensors_tpu_torch.transform.hadamard import (  # noqa: F401
    deterministic_hadamard_matrix,
    hadamard_matrix,
    high_precision_invert,
    is_pow2,
    random_hadamard_matrix,
    random_matrix,
)
from compressed_tensors_tpu_torch.transform.apply import (  # noqa: F401
    HadamardFactory,
    OnlineTransform,
    RandomHadamardFactory,
    RandomMatrixFactory,
    TransformFactory,
    apply_transform_config,
    apply_transform_weight,
    get_transform_size,
    multihead_matmul,
)
