from compressed_tensors_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    dp_rows,
    llama_param_specs,
    make_mesh,
    shard_kv_cache,
    shard_llama_params,
)
from compressed_tensors_tpu_torch.parallel.overlap import (  # noqa: F401
    matmul_reducescatter,
    ring_allgather_matmul,
    ring_allgather_matmul_fn,
    ring_allgather_matmul_quantized,
)
from compressed_tensors_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_forward,
    stack_stage_params,
)
