"""whisper-small [audio]: enc-dec transformer; conv/mel frontend is a STUB [arXiv:2212.04356].

the batch provides precomputed frame embeddings (B, 1500, D) for the
encoder; we implement the full encoder-decoder transformer (bidirectional
encoder, causal decoder with cross-attention, sinusoidal positions, plain
GELU MLPs).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    arch_type="audio",
    num_layers=12,          # decoder layers
    encoder_layers=12,
    encoder_seq=1500,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    mlp_act="gelu",
    citation="Whisper: Robust Speech Recognition [arXiv:2212.04356]",
)
