"""AdamW (Loshchilov & Hutter 2019), counterpart of ``repro/core/adamw.py``.

The scalar/1-D/embedding optimizer inside the combined Muon setups, with
decoupled weight decay and global-norm clipping of its own gradients.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.core.muon import Optimizer, _as_schedule


class AdamWState(NamedTuple):
    mu: dict    # path -> first moment
    nu: dict    # path -> second moment
    count: int


def adamw(
    learning_rate,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_clip: float | None = 1.0,
) -> Optimizer:
    lr_fn = _as_schedule(learning_rate)

    def init(params) -> AdamWState:
        flat = tree_lib.flatten_with_path(params)
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(
            mu={k: zeros(p) for k, p in flat}, nu={k: zeros(p) for k, p in flat}, count=0
        )

    @torch.no_grad()
    def update(grads, state: AdamWState, params, phase: str = "block"):
        del phase  # coordinate-wise: no block/full distinction
        count = state.count + 1
        lr = float(lr_fn(count))
        flat = tree_lib.flatten_with_path(grads)
        p_by_key = dict(tree_lib.flatten_with_path(params))
        gs = {k: g.to(torch.float32) for k, g in flat}
        if grad_clip is not None and gs:
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in gs.values()))
            scale = torch.clamp(grad_clip / (gnorm + 1e-12), max=1.0)
            gs = {k: g * scale for k, g in gs.items()}
        new_mu = {k: b1 * state.mu[k] + (1 - b1) * g for k, g in gs.items()}
        new_nu = {k: b2 * state.nu[k] + (1 - b2) * (g * g) for k, g in gs.items()}
        c1 = 1 - b1 ** count
        c2 = 1 - b2 ** count
        items = []
        for k in gs:
            p = p_by_key[k]
            upd = -lr * (new_mu[k] / c1) / (torch.sqrt(new_nu[k] / c2) + eps)
            if weight_decay:
                upd = upd - lr * weight_decay * p.to(torch.float32)
            items.append((k, upd.to(p.dtype)))
        return tree_lib.unflatten(items), AdamWState(mu=new_mu, nu=new_nu, count=count)

    return Optimizer(init=init, update=update)
