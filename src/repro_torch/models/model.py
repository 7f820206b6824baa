"""Model API: init / loss / prefill / decode for every arch
(counterpart of ``repro/models/model.py``).

A batch is ``{"tokens", "labels"}``, plus ``"vision_embeds"`` (B, V, D)
for the VLM and ``"audio_frames"`` (B, S_enc, D) for whisper.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import decode_step, forward, init_cache, init_params

IGNORE_LABEL = -1
LB_COEF = 0.01     # load-balance aux coefficient (Switch/OLMoE-style)
Z_COEF = 0.001     # router z-loss coefficient


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Masked mean CE. logits (B, S, V) any dtype; labels (B, S) with -1 ignored."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels != IGNORE_LABEL).to(torch.float32)
    return torch.sum((lse - label_logit) * mask) / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, *, ctx=None,
            remat: bool = True) -> tuple[torch.Tensor, dict]:
    """(loss, metrics): the masked CE, plus ``LB_COEF * load_balance +
    Z_COEF * z_loss`` for an MoE model, whose metrics then also carry the
    layer-summed ``load_balance`` and ``z_loss``. A VLM's logits at its
    ``vision_tokens`` leading positions are dropped before the CE, whose
    mean counts the text positions only, as the reference's.

    ``ctx`` (``sharding.specs.ShardCtx``) is passed to ``forward``; on a
    tensor-parallel rank the CE is the vocab-parallel one over the rank's
    logit columns (``distributed.tensor_parallel.cross_entropy``), so the
    whole (B, S, Vp) logits never exist; with the vocab whole on every rank
    (``ctx.vocab_whole``) every rank has them and computes the plain CE. ``remat`` goes to ``forward``: on,
    as in the reference, every layer is checkpointed; the launcher has no
    flag for it."""
    logits, aux = forward(params, batch["tokens"], cfg, return_aux=True,
                          extra_embeds=batch.get("vision_embeds"),
                          encoder_frames=batch.get("audio_frames"), ctx=ctx, remat=remat)
    if cfg.vision_tokens:
        logits = logits[:, cfg.vision_tokens:, :]
    if ctx is not None and ctx.tensor_parallel and not ctx.vocab_whole:
        from repro_torch.distributed import tensor_parallel

        ce = tensor_parallel.cross_entropy(logits, batch["labels"], ctx, ignore=IGNORE_LABEL)
    else:
        ce = cross_entropy(logits, batch["labels"])
    loss = ce
    metrics = {"ce": ce}
    if cfg.num_experts:
        loss = loss + LB_COEF * aux["load_balance"] + Z_COEF * aux["z_loss"]
        metrics.update(aux)
    metrics["loss"] = loss
    return loss, metrics


def prefill(params: dict, batch: dict, cfg: ModelConfig, *, ctx=None):
    """Full-sequence prefill of ``batch["tokens"]`` (and the batch's
    ``vision_embeds`` / ``audio_frames``): returns ``(logits, cache)`` (the
    reference returns its aux losses between them; a caller that wants them
    calls ``forward(mode="prefill", return_aux=True)``). ``ctx``
    (``sharding.specs.ShardCtx``) gives the head layouts and the
    attention's ``flash_block_k``; without one, 1024, as the serving
    engine's prefill takes it. Tensor-parallel (a context made for a decode
    layout, ``sharding.specs.make_ctx(..., batch=, cache_len=)``), the
    rank's shards prefill its data coordinate's rows, and the logits are
    its vocab columns and the cache its ``cache_specs`` shard of the
    decode buffer, which ``decode_step(ctx=)`` takes as it is (see
    ``transformer.forward``)."""
    return forward(params, batch["tokens"], cfg, mode="prefill",
                   extra_embeds=batch.get("vision_embeds"),
                   encoder_frames=batch.get("audio_frames"), ctx=ctx)


__all__ = ["IGNORE_LABEL", "LB_COEF", "Z_COEF", "cross_entropy", "decode_step", "forward",
           "init_cache", "init_params", "loss_fn", "prefill"]
