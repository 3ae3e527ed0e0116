from compressed_tensors_tpu_torch.distributed.assign import (  # noqa: F401
    greedy_bin_packing,
)
from compressed_tensors_tpu_torch.distributed.utils import (  # noqa: F401
    broadcast_object,
    init_dist,
    is_distributed,
    process_count,
    process_index,
)
from compressed_tensors_tpu_torch.distributed.module_parallel import (  # noqa: F401
    compress_state_parallel,
    partition_modules,
)
