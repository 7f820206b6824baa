"""internvl2-1b [vlm]: InternViT (stub) + Qwen2-0.5B-style LM backbone [arXiv:2404.16821].

Per the assignment carve-out the vision encoder + projector are a STUB:
the batch provides precomputed patch embeddings (B, vision_tokens, D)
prepended to the token stream; we implement the language decoder.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    arch_type="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    vision_tokens=256,
    rope_theta=1e6,
    citation="InternVL2 / How Far Are We to GPT-4V [arXiv:2404.16821]",
)
