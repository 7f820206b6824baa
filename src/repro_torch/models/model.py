"""Model API, dense training subset (counterpart of ``repro/models/model.py``)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import forward, init_params

IGNORE_LABEL = -1


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Masked mean CE. logits (B, S, V) any dtype; labels (B, S) with -1 ignored."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels != IGNORE_LABEL).to(torch.float32)
    return torch.sum((lse - label_logit) * mask) / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    logits = forward(params, batch["tokens"], cfg)
    ce = cross_entropy(logits, batch["labels"])
    return ce, {"ce": ce, "loss": ce}


__all__ = ["IGNORE_LABEL", "cross_entropy", "forward", "init_params", "loss_fn"]
