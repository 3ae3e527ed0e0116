from compressed_tensors_tpu_torch.modeling.attention import (  # noqa: F401
    AttentionQuantState,
    calibrate_kv_scales,
    initialize_hooked_attention,
    initialize_hooked_kv_cache,
    quantize_post_rope,
    register_key_hook,
    register_query_hook,
    register_value_hook,
    validate_attention_scheme,
)
