"""Greedy decode: a prefill step and single-token decode steps over a
fixed-size KV cache.

Counterpart of ``compressed_tensors_tpu/engine/generate.py``. Steps run
eagerly; the cache is updated in place.
"""

from __future__ import annotations

import torch

from compressed_tensors_tpu_torch.models.config import LlamaConfig
from compressed_tensors_tpu_torch.models.llama import (
    init_kv_cache,
    llama_forward,
    resolve_device,
)
from compressed_tensors_tpu_torch.parallel.mesh import local_config

__all__ = ["greedy_generate", "make_step_fns"]


def make_step_fns(config: LlamaConfig, max_len: int, dtype=torch.bfloat16,
                  cache_dtype=None, use_kernels: bool = True, device="cuda"):
    """(prefill, decode) step functions over a cache of ``max_len``. The
    params may be a rank's slice (``parallel.shard_llama_params``): the
    cache then holds its kv heads and every rank gets the full logits.
    Each rank runs the whole batch: over a dp mesh the params are
    replicated and nothing is gathered over "dp"."""
    device = resolve_device(device)

    def prefill(params, input_ids, prompt_len: int):
        B, S = input_ids.shape
        cache = init_kv_cache(local_config(params, config), B, max_len,
                              dtype=dtype,
                              cache_dtype=cache_dtype, device=device)
        positions = torch.arange(S, device=device).expand(B, S)
        # unpadded prompt: only the last position's logits matter; a padded
        # prompt (prompt_len < S) samples at its last real position
        unpadded = prompt_len == S
        logits, cache = llama_forward(params, config, input_ids, positions,
                                      cache, fresh_prefill=True,
                                      use_kernels=use_kernels,
                                      last_logit_only=unpadded)
        last = -1 if unpadded else prompt_len - 1
        next_token = torch.argmax(logits[:, last, :], dim=-1)
        return next_token.to(torch.int32), cache, logits

    def decode(params, token, cache):
        positions = cache.lengths[:, None]
        logits, cache = llama_forward(params, config, token[:, None],
                                      positions, cache,
                                      use_kernels=use_kernels)
        next_token = torch.argmax(logits[:, -1, :], dim=-1)
        return next_token.to(torch.int32), cache

    return prefill, decode


def greedy_generate(params, config: LlamaConfig, input_ids,
                    max_new_tokens: int = 32, dtype=torch.bfloat16,
                    cache_dtype=None, eos_token_id: int | None = None,
                    use_kernels: bool = True, device="cuda"):
    """Greedy decode. input_ids: (B, S) ints. Returns (B, S + new) ids."""
    device = resolve_device(device)
    input_ids = torch.as_tensor(input_ids, dtype=torch.int64, device=device)
    B, S = input_ids.shape
    prefill, decode = make_step_fns(config, S + max_new_tokens, dtype=dtype,
                                    cache_dtype=cache_dtype,
                                    use_kernels=use_kernels, device=device)
    token, cache, _ = prefill(params, input_ids, S)
    out = [token]
    for _ in range(max_new_tokens - 1):
        token, cache = decode(params, token, cache)
        out.append(token)
        if eos_token_id is not None and bool((token == eos_token_id).all()):
            break
    return torch.cat([input_ids.to(torch.int32), torch.stack(out, dim=1)],
                     dim=1)
