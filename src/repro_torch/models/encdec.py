"""Whisper-style encoder (bidirectional) over stub frame embeddings.

Counterpart of ``repro/models/encdec.py``. The mel-spectrogram and conv
feature extractor are a stub, as in the reference: the batch carries
``audio_frames`` (B, encoder_seq, d_model). This module is the transformer
encoder; the decoder (causal self-attention, cross-attention to the
encoder's output) is ``transformer.decoder_layer``.

Frames and weights of other dtypes promote (``layers.linear``): in bf16
training the reference's encoder meets fp32 frames and so runs in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import attention_block, linear, rms_norm, sinusoidal_positions


def init_encoder_params(gen: torch.Generator, cfg: ModelConfig, *, device="cuda",
                        dtype=torch.float32) -> dict:
    """The encoder subtree: ``attn/{wq,wk,wv,wo}`` and ``mlp/{wi,wo}``
    stacked over ``encoder_layers``, ``norms/{attn,mlp}_norm`` and
    ``final_norm``, with the reference's init law (N(0, 0.02), unit gains)."""
    L, D, F_ = cfg.encoder_layers, cfg.d_model, cfg.d_ff

    def init(*shape):
        return (0.02 * torch.randn(shape, generator=gen, device=device,
                                   dtype=torch.float32)).to(dtype)

    ones = lambda *shape: torch.ones(shape, device=device, dtype=dtype)
    return {
        "attn": {"wq": init(L, D, cfg.q_dim), "wk": init(L, D, cfg.kv_dim),
                 "wv": init(L, D, cfg.kv_dim), "wo": init(L, cfg.q_dim, D)},
        "mlp": {"wi": init(L, D, F_), "wo": init(L, F_, D)},
        "norms": {"attn_norm": ones(L, D), "mlp_norm": ones(L, D)},
        "final_norm": ones(D),
    }


def encode(enc_params: dict, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, S_enc, D) stub embeddings -> (B, S_enc, D) encodings.

    Sinusoidal positions added to the frames, then pre-norm bidirectional
    attention (no RoPE, no mask) and a tanh-GELU MLP per layer, and a final
    RMSNorm.
    """
    seq = frames.shape[1]
    x = frames + sinusoidal_positions(seq, cfg.d_model, device=frames.device).to(frames.dtype)[None]
    positions = torch.arange(seq, device=frames.device)
    for i in range(enc_params["attn"]["wq"].shape[0]):
        attn = {k: w[i] for k, w in enc_params["attn"].items()}
        h = rms_norm(x, enc_params["norms"]["attn_norm"][i])
        attn_out, _ = attention_block(
            h, attn, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, positions=positions, inv_freq=None, causal=False)
        x = x + attn_out
        h = rms_norm(x, enc_params["norms"]["mlp_norm"][i])
        x = x + linear(F.gelu(linear(h, enc_params["mlp"]["wi"][i]), approximate="tanh"),
                       enc_params["mlp"]["wo"][i])
    return rms_norm(x, enc_params["final_norm"])
