"""AdamW (Loshchilov & Hutter 2019), counterpart of ``repro/core/adamw.py``.

The scalar/1-D/embedding optimizer inside the combined Muon setups, with
decoupled weight decay and global-norm clipping of its own gradients.

With ``comm=`` (``distributed.engine.ShardMapEngine``) the moments live in
each leaf's momentum spec (ZeRO-1 splits the embedding's and the head's
lead dim): the clipping norm is taken over the whole AdamW group on the
data-reduced gradients as the rank holds them (on the tensor-parallel path
the vocab-split embedding's and head's shards are summed over the model
axis, ``engine.global_sq_sum``), then each rank cuts its shard; the
updates come back in the momentum layout, as ``core.muon``'s.
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
    comm=None,
) -> Optimizer:
    lr_fn = _as_schedule(learning_rate)
    local = (lambda k, x: x) if comm is None else comm.shard

    def init(params) -> AdamWState:
        flat = tree_lib.flatten_with_path(params)
        shape = lambda k, p: (tuple(p.shape) if comm is None
                              else comm.local_shape(k, comm.full_shape(k, p.shape)))
        zeros = lambda k, p: torch.zeros(shape(k, p), dtype=torch.float32, device=p.device)
        return AdamWState(
            mu={k: zeros(k, p) for k, p in flat}, nu={k: zeros(k, p) for k, p in flat}, count=0
        )

    @torch.no_grad()
    def update(grads, state: AdamWState, params, phase: str = "block"):
        del phase  # coordinate-wise: no block/full distinction
        count = state.count + 1
        lr = float(lr_fn(count))
        flat = tree_lib.flatten_with_path(grads)
        p_by_key = dict(tree_lib.flatten_with_path(params))
        gs = {k: g.to(torch.float32) for k, g in flat}
        scale = None
        if grad_clip is not None and gs:
            if comm is not None:
                gnorm = torch.sqrt(comm.global_sq_sum(gs.items()))
            else:
                gnorm = torch.sqrt(sum(torch.sum(g * g) for g in gs.values()))
            scale = torch.clamp(grad_clip / (gnorm + 1e-12), max=1.0)
        c1 = 1 - b1 ** count
        c2 = 1 - b2 ** count
        new_mu, new_nu, items = {}, {}, []
        for k, g in gs.items():
            # One leaf at a time, in place where the op allows (the same
            # ops, so the same values): a whole embedding (a vocab no model
            # axis divides, on every rank) keeps two temporaries of its size.
            g = local(k, g if scale is None else g * scale)
            new_mu[k] = (state.mu[k] * b1).add_(g * (1 - b1))
            new_nu[k] = (state.nu[k] * b2).add_((g * g).mul_(1 - b2))
            del g
            p = p_by_key[k]
            den = new_nu[k] / c2
            upd = (new_mu[k] / c1).mul_(-lr).div_(den.sqrt_().add_(eps))
            del den
            if weight_decay:
                upd.sub_(local(k, p.to(torch.float32)) * (lr * weight_decay))
            items.append((k, upd.to(p.dtype)))
        return tree_lib.unflatten(items), AdamWState(mu=new_mu, nu=new_nu, count=count)

    return Optimizer(init=init, update=update)
