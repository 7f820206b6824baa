"""gemma2-9b [dense]: alternating local/global attention, logit softcaps [arXiv:2408.00118]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    arch_type="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    attention_pattern="alternating",
    window_size=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp_act="geglu",
    use_post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
    citation="Gemma 2 [arXiv:2408.00118]",
)
