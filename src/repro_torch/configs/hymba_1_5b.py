"""hymba-1.5b [hybrid]: parallel attention + mamba heads per layer [arXiv:2411.13676].

Meta-tokens and per-head gating simplified to learned per-branch scales, as
in the reference; the parallel attn||SSM structure and SWA are preserved.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    attention_pattern="swa",
    window_size=1024,
    ssm_state=16,
    ssm_head_dim=64,
    citation="Hymba: A Hybrid-head Architecture [arXiv:2411.13676]",
)
