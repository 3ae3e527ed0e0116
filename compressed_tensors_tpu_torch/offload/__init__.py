from compressed_tensors_tpu_torch.offload.cache import (  # noqa: F401
    DeviceCache,
    DiskCache,
    HostCache,
    OffloadCache,
    disable_offloading,
    disable_onloading,
)
from compressed_tensors_tpu_torch.offload.dispatch import (  # noqa: F401
    SearchFailureError,
    dispatch_plan,
    max_binary_search,
)
from compressed_tensors_tpu_torch.offload.load import (  # noqa: F401
    load_sharded_params,
    stream_modules,
)
