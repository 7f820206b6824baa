"""mamba2-1.3b [ssm]: attention-free SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    citation="Transformers are SSMs (Mamba-2 / SSD) [arXiv:2405.21060]",
)
