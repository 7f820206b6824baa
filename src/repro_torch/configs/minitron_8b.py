"""minitron-8b [dense]: pruned Nemotron-4 [arXiv:2407.14679]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    citation="Minitron: Compact LMs via Pruning+Distillation [arXiv:2407.14679]",
)
