"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attention [arXiv:2401.04088]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    attention_pattern="swa",
    window_size=4096,
    num_experts=8,
    top_k=2,
    router_style="topk_softmax",
    rope_theta=1e6,
    citation="Mixtral of Experts [arXiv:2401.04088]",
)
