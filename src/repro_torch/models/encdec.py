"""Whisper-style encoder (bidirectional) over stub frame embeddings.

Counterpart of ``repro/models/encdec.py``. The mel-spectrogram and conv
feature extractor are a stub, as in the reference: the batch carries
``audio_frames`` (B, encoder_seq, d_model). This module is the transformer
encoder; the decoder (causal self-attention, cross-attention to the
encoder's output) is ``transformer.decoder_layer``.

Frames and weights of other dtypes promote (``layers.linear``): in bf16
training the reference's encoder meets fp32 frames and so runs in fp32.

Tensor-parallel, the encoder runs on the rank's column and row shards
through the decoder's collectives, with the reference's sequence rule
applied to its own length: where the model axis divides ``S_enc``, each
rank runs the layers on its slice of the frames and the output is gathered
once into the whole (B, S_enc, D) K/V source (``tensor_parallel.
gather_seq``). That gather's backward sums the partial cotangents that each
rank's cross-attention heads send back from every decoder layer (a
reduce-scatter; unsharded, ``gather_seq``'s all-reduce). A sub-block that
the axis leaves whole (no head layout, a ``d_ff`` it does not divide) runs
whole on every rank (``tensor_parallel.enter_whole`` / ``leave_whole``),
and with whole heads so does the cross-attention, whose whole cotangent of
the encoder output each rank then cuts to its slice. The reference lets
GSPMD lay the encoder out and sums the same terms in another order: a
departure by design, with the same result up to rounding.
"""

from __future__ import annotations

import dataclasses

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


def encode(enc_params: dict, frames: torch.Tensor, cfg: ModelConfig, ctx=None) -> torch.Tensor:
    """frames: (B, S_enc, D) stub embeddings -> (B, S_enc, D) encodings.

    Sinusoidal positions added to the frames, then pre-norm bidirectional
    attention (no RoPE, no mask) and a tanh-GELU MLP per layer, and a final
    RMSNorm. ``ctx`` (``sharding.specs.ShardCtx``) gives the head layouts,
    as the reference's does; tensor-parallel, ``enc_params`` are the rank's
    shards and the encoder's residual follows ``ctx.encoder_seq_shard`` (see
    the module doc). The output is whole on every rank. Its self-attention
    scans K/V in ``attention_block``'s default blocks of 1024 whatever
    ``ctx.flash_block_k`` says, as the reference's ``encode`` passes no
    block size; the decoder's cross-attention takes the context's.
    """
    seq = frames.shape[1]
    tp = ctx is not None and ctx.tensor_parallel
    x = frames + sinusoidal_positions(seq, cfg.d_model, device=frames.device).to(frames.dtype)[None]
    enter = leave = lambda h, whole=False: h
    if tp:
        from repro_torch.distributed import tensor_parallel
        from repro_torch.sharding.specs import sequence_sharded

        if ctx.encoder_seq_shard != sequence_sharded(seq, ctx.size):
            raise ValueError(f"the context's encoder_seq_shard={ctx.encoder_seq_shard} was made "
                             f"for another encoder length than {seq}")
        ctx = dataclasses.replace(ctx, seq_shard=ctx.encoder_seq_shard)
        if ctx.seq_shard:
            x = x.narrow(1, ctx.index * (seq // ctx.size), seq // ctx.size)
        enter = lambda h, whole=False: (tensor_parallel.enter_whole if whole else
                                        tensor_parallel.gather_seq)(h, ctx)
        leave = lambda h, whole=False: (tensor_parallel.leave_whole if whole else
                                        tensor_parallel.reduce_seq)(h, ctx)
    attn_whole, mlp_whole = tp and ctx.attn_whole, tp and ctx.mlp_whole
    positions = torch.arange(seq, device=frames.device)
    for i in range(enc_params["attn"]["wq"].shape[0]):
        attn = {k: w[i] for k, w in enc_params["attn"].items()}
        h = enter(rms_norm(x, enc_params["norms"]["attn_norm"][i]), attn_whole)
        attn_out, _ = attention_block(
            h, attn, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, positions=positions, inv_freq=None, causal=False, ctx=ctx)
        x = x + leave(attn_out, attn_whole)
        h = enter(rms_norm(x, enc_params["norms"]["mlp_norm"][i]), mlp_whole)
        x = x + leave(linear(F.gelu(linear(h, enc_params["mlp"]["wi"][i]), approximate="tanh"),
                             enc_params["mlp"]["wo"][i]), mlp_whole)
    x = rms_norm(x, enc_params["final_norm"])
    # The decoder's cross-attention reads it: its K/V heads split or whole
    # decide which backward the gather takes (the sum of the partial
    # cotangents, or the rank's slice of the whole one).
    return enter(x, attn_whole)
