"""Model API: init / loss / prefill / decode for the dense and MoE archs
(counterpart of ``repro/models/model.py``)."""

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


def loss_fn(params: dict, batch: dict, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """(loss, metrics): the masked CE, plus ``LB_COEF * load_balance +
    Z_COEF * z_loss`` for an MoE model, whose metrics then also carry the
    layer-summed ``load_balance`` and ``z_loss``."""
    logits, aux = forward(params, batch["tokens"], cfg, return_aux=True)
    ce = cross_entropy(logits, batch["labels"])
    loss = ce
    metrics = {"ce": ce}
    if cfg.num_experts:
        loss = loss + LB_COEF * aux["load_balance"] + Z_COEF * aux["z_loss"]
        metrics.update(aux)
    metrics["loss"] = loss
    return loss, metrics


def prefill(params: dict, batch: dict, cfg: ModelConfig):
    """Full-sequence prefill of ``batch["tokens"]``: returns ``(logits, cache)``
    (the reference returns its aux losses between them; a caller that wants
    them calls ``forward(mode="prefill", return_aux=True)``)."""
    return forward(params, batch["tokens"], cfg, mode="prefill")


__all__ = ["IGNORE_LABEL", "LB_COEF", "Z_COEF", "cross_entropy", "decode_step", "forward",
           "init_cache", "init_params", "loss_fn", "prefill"]
