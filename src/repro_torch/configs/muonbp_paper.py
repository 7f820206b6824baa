"""The paper's Llama-style experiment architectures (Table 5).

Counterpart of ``repro/configs/muonbp_paper.py``: GQA + RoPE + SwiGLU,
Llama-3 vocabulary.
"""

from repro_torch.configs.base import ModelConfig


def _llama(name, layers, heads, kv, hidden, d_ff=None, vocab=128256):
    return ModelConfig(
        name=name,
        arch_type="dense",
        num_layers=layers,
        d_model=hidden,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=hidden // heads,
        d_ff=d_ff if d_ff is not None else hidden * 4,
        vocab_size=vocab,
        citation="MuonBP paper Table 5 (Llama-style, Llama-3 tokenizer)",
    )


PAPER_CONFIGS = {
    "muonbp-960m": _llama("muonbp-960m", 12, 16, 4, 1536, d_ff=6144),
    "muonbp-1.2b": _llama("muonbp-1.2b", 14, 16, 4, 1792, d_ff=7168),
    "muonbp-8b": _llama("muonbp-8b", 32, 32, 8, 4096, d_ff=14336),
}
