"""Model configuration parsed from HF config.json.

Counterpart of ``compressed_tensors_tpu/models/config.py`` (the same
fields, so the same config.json parses the same way in both packages):
the dense Llama family with the Qwen2 qkv bias and the Qwen3 q/k norms,
MoE layers (Mixtral, Qwen-MoE, DeepSeek naming) and DeepSeek V2/V3
multi-head latent attention (``kv_lora_rank`` > 0; the rope dims of
``deepseek*`` checkpoints are interleaved, ``rope_interleaved``). This
port's forward pass serves all of them.
"""

from __future__ import annotations

import dataclasses
import json
import os

__all__ = ["LlamaConfig"]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_hidden_layers: int = 22
    num_attention_heads: int = 32
    num_key_value_heads: int = 4
    head_dim: int = 64
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 2048
    tie_word_embeddings: bool = False
    attention_bias: bool = False   # qkv-projection bias (Qwen2 family)
    qk_norm: bool = False          # per-head q/k RMSNorm (Qwen3 family)

    # MLA (DeepSeek V2/V3 multi-head latent attention; 0 -> standard GQA)
    # rope_interleaved: the checkpoint's rope dims use the interleaved
    # (GPT-J) pairing rather than the llama half-rotation layout. DeepSeek
    # V2/V3 train this way (HF uses apply_rotary_pos_emb_interleave; vLLM
    # sets is_neox_style=False). The loader converts it to half layout by
    # permuting the rope-dim output rows of kv_a_proj_with_mqa and
    # q_proj/q_b_proj at load time — the permutation commutes with the
    # rotation, so attention dots are exactly the interleaved ones while
    # the engine keeps its lane-friendly half-rotation kernels.
    rope_interleaved: bool = False
    q_lora_rank: int = 0           # 0 -> dense q_proj (V2-lite style)
    kv_lora_rank: int = 0          # latent KV rank; >0 enables MLA
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE (0 experts -> dense MLP everywhere)
    num_local_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: int = 0       # per-expert FFN width
    shared_expert_intermediate_size: int = 0  # 0 -> no shared expert
    first_k_dense_replace: int = 0       # leading layers that stay dense
    norm_topk_prob: bool = True          # renormalize top-k router weights

    @property
    def is_moe(self) -> bool:
        return self.num_local_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def layer_is_moe(self, layer_idx: int) -> bool:
        return self.is_moe and layer_idx >= self.first_k_dense_replace

    @classmethod
    def from_dict(cls, d: dict) -> "LlamaConfig":
        head_dim = d.get("head_dim") or (
            d["hidden_size"] // d["num_attention_heads"]
        )
        # MoE field aliases across HF model families
        num_experts = (
            d.get("num_local_experts")      # mixtral
            or d.get("num_experts")         # qwen2/3-moe
            or d.get("n_routed_experts")    # deepseek
            or 0
        )
        moe_inter = (
            d.get("moe_intermediate_size")  # qwen/deepseek
            or (d.get("intermediate_size") if num_experts else 0)  # mixtral
            or 0
        )
        model_type = d.get("model_type", "llama")
        return cls(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
            num_key_value_heads=d.get("num_key_value_heads",
                                      d["num_attention_heads"]),
            head_dim=head_dim,
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            rope_theta=d.get("rope_theta", 10000.0),
            max_position_embeddings=d.get("max_position_embeddings", 2048),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            attention_bias=d.get(
                "attention_bias",
                # Qwen2 applies qkv bias unconditionally (no config flag)
                model_type in ("qwen2", "qwen2_moe"),
            ),
            # Qwen3 applies per-head q/k RMSNorm unconditionally
            qk_norm=model_type in ("qwen3", "qwen3_moe"),
            rope_interleaved=model_type.startswith("deepseek"),
            q_lora_rank=d.get("q_lora_rank") or 0,
            kv_lora_rank=d.get("kv_lora_rank") or 0,
            qk_nope_head_dim=d.get("qk_nope_head_dim") or 0,
            qk_rope_head_dim=d.get("qk_rope_head_dim") or 0,
            v_head_dim=d.get("v_head_dim") or 0,
            num_local_experts=num_experts,
            num_experts_per_tok=(
                d.get("num_experts_per_tok") or d.get("top_k") or 2
            ),
            moe_intermediate_size=moe_inter,
            shared_expert_intermediate_size=d.get(
                "shared_expert_intermediate_size", 0
            ) or 0,
            first_k_dense_replace=d.get("first_k_dense_replace", 0) or 0,
            norm_topk_prob=d.get("norm_topk_prob", True),
        )

    @classmethod
    def from_pretrained(cls, path: str) -> "LlamaConfig":
        with open(os.path.join(path, "config.json")) as f:
            return cls.from_dict(json.load(f))
