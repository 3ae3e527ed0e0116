from compressed_tensors_tpu_torch.models.config import LlamaConfig  # noqa: F401
from compressed_tensors_tpu_torch.models.llama import (  # noqa: F401
    KVCache,
    PagedKVCache,
    init_kv_cache,
    init_paged_kv_cache,
    llama_forward,
    load_llama_params,
)
