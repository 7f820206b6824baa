"""phi4-mini-3.8b [dense]: RoPE + SwiGLU + GQA, 200k vocab, tied embeds [arXiv:2412.08905]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    tie_embeddings=True,
    rope_theta=10000.0,
    citation="Phi-4 Technical Report [arXiv:2412.08905]",
)
