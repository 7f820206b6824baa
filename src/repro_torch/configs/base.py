"""Model configuration dataclass (counterpart of ``repro/configs/base.py``).

The port keeps its own copy: it imports nothing of the JAX package. Field
names, defaults and :meth:`ModelConfig.reduced` match the reference so a
config built on either side describes the same model.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    citation: str = ""

    # attention
    attention_pattern: str = "full"    # full | swa | alternating
    window_size: int = 4096
    rope_theta: float = 10000.0
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    mlp_act: str = "swiglu"            # swiglu | geglu
    tie_embeddings: bool = False
    embed_scale: bool = False          # gemma-style sqrt(d_model) scaling
    use_post_norms: bool = False       # gemma2 pre+post norms

    # moe
    num_experts: int = 0
    top_k: int = 0
    router_style: str = "topk_softmax"
    capacity_factor: float = 1.25

    # ssm (mamba2 / hymba)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2

    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0

    # vlm
    vision_tokens: int = 0

    # misc
    vocab_pad_multiple: int = 256
    norm_eps: float = 1e-6

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family, tiny dims (same rule as the reference)."""
        d_model = min(self.d_model, 256)
        head_dim = min(self.head_dim, 32)
        num_heads = max(2, min(self.num_heads, 4))
        num_kv = max(1, min(self.num_kv_heads, 2))
        if self.num_heads == self.num_kv_heads:  # MHA archs stay MHA
            num_kv = num_heads
        return dataclasses.replace(
            self,
            num_layers=2,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            vocab_pad_multiple=64,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=min(self.ssm_head_dim, 32) if self.ssm_state else 64,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=min(self.encoder_seq, 64) if self.encoder_seq else 0,
            vision_tokens=min(self.vision_tokens, 16) if self.vision_tokens else 0,
            window_size=min(self.window_size, 64),
        )
