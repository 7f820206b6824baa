"""Mixture-of-Experts block (counterpart of ``repro/models/moe.py``).

Capacity-based routing, GShard-style dropping, in the reference's order:

  1. router logits (fp32) -> top-k experts + gate weights per token;
  2. flat (token, expert) assignments sorted by expert id with a stable
     sort, so that ties keep token order;
  3. rank within the expert by ``searchsorted``; ranks at or past the
     capacity are dropped;
  4. a dense ``(E, C, D)`` buffer -> the experts' SwiGLU -> ``(E, C, D)``;
  5. each assignment's output back by its slot, times its gate, and each
     token's ``top_k`` outputs summed in the activation dtype in
     expert-sorted order, as the reference's scatter-add leaves them.

The reference's routing is plain ``jnp``, with no Pallas kernel, so this
module is plain PyTorch.

Tensor-parallel (``ctx``, a tensor-parallel ``sharding.specs.ShardCtx``):
the reference runs the block under ``shard_map``, each data shard's tokens
routed locally and the experts' ``d_ff`` split over ``model``, with one
psum of the ``(E, C, D)`` expert output before the combine
(``repro/models/moe.py:98-104``). Here every model rank routes the whole
sequence of its data coordinate's rows (the caller gathers it, so the
capacity is the reference's per data shard), runs its ``(E, D, F/m)`` /
``(E, F/m, D)`` expert shards and returns the partial output; the caller
sums it over ``model`` after the combine (``tensor_parallel.reduce_seq``).
The combine is linear in the expert output, so that is the same sum in
another order, over ``rows * S`` rows instead of ``E * C``. The router
logits, gates and aux losses are computed alike on every model rank; the
aux losses go through ``tensor_parallel.replica_mean``, so the gradient
sums over ``model`` count them once.

Determinism. The reference scatter-adds; ``index_add_`` on CUDA adds
atomically, so a bf16 sum would change from run to run. Here every
scatter writes distinct rows (the dropped assignments' dump row aside,
which nothing reads), and each token's sum is a gather to ``(T, k, D)``
added in a fixed order, forward and backward.

Routing by groups. ``group_rows=True`` routes each row of the batch as its
own group: its own capacity, ranks and aux losses (the aux the mean over
rows, as the reference averages them over data shards). That is what the
reference's serving engine computes when it ``vmap``s a batch-1 decode over
its slots, so a slot's tokens never depend on its co-batch.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class MoEOutput(NamedTuple):
    y: torch.Tensor
    load_balance_loss: torch.Tensor
    router_z_loss: torch.Tensor


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, descending, a
    tie to the lower index. Like it, the order is total: -0.0 ranks below
    +0.0. The sort runs on the fp32 bits mapped to ordered int32 keys, and
    stable, so equal keys keep the lower index first."""
    bits = x.to(torch.float32).view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


def _route(logits: torch.Tensor, top_k: int, style: str):
    """logits: (..., E) fp32 -> (gates (..., k), experts (..., k))."""
    if style == "topk_softmax":  # mixtral: select then softmax over selected
        top_logits, top_idx = _top_k(logits, top_k)
        gates = torch.softmax(top_logits, dim=-1)
    elif style == "softmax_topk":  # olmoe: softmax over all, select, renorm
        probs = torch.softmax(logits, dim=-1)
        gates, top_idx = _top_k(probs, top_k)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    else:
        raise ValueError(f"unknown router style {style!r}")
    return gates, top_idx


def _dispatch(flat_expert: torch.Tensor, num_experts: int, capacity: int):
    """Each group's flat (token, expert) assignments in the reference's order.

    ``flat_expert``: (G, T*k) expert ids, token-major. Returns ``(order,
    slot, valid)``, each (G, T*k) in sorted order: ``order`` the flat
    assignment at each sorted place (a stable sort by expert, so ties keep
    token order), ``slot`` its buffer row ``expert * capacity + rank``
    (``num_experts * capacity``, the dump row, when dropped), ``valid``
    whether its rank within the expert is under ``capacity``.
    """
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    sorted_expert = torch.gather(flat_expert, -1, order)
    # rank of each entry within its expert's run
    first_occurrence = torch.searchsorted(sorted_expert, sorted_expert, side="left")
    rank = torch.arange(flat_expert.shape[-1], device=flat_expert.device) - first_occurrence
    valid = rank < capacity
    slot = torch.where(valid, sorted_expert * capacity + rank, num_experts * capacity)
    return order, slot, valid


def _local_moe(x, router, wi, wg, wo, *, top_k: int, capacity_factor: float,
               router_style: str, group_rows: bool = False):
    """x: (b, S, D); router (D, E); wi/wg (E, D, F); wo (E, F, D) (F: the
    whole ``d_ff`` or a rank's slice, then ``y`` is the partial sum).

    Returns ``(y (b, S, D), load_balance, z_loss)``. The groups are the
    whole batch (the reference's ``_local_moe``) or, with ``group_rows``,
    each row alone.
    """
    b, s, d = x.shape
    num_experts = wi.shape[0]
    groups, t = (b, s) if group_rows else (1, b * s)
    dev = x.device
    xf = x.reshape(groups, t, d)

    logits = xf.to(torch.float32) @ router.to(torch.float32)        # (G, T, E)
    gates, top_idx = _route(logits, top_k, router_style)

    # Aux losses of each group, averaged over the groups.
    probs = torch.softmax(logits, dim=-1)
    assign = torch.zeros_like(probs).scatter_(-1, top_idx, 1.0)
    frac_tokens = assign.mean(dim=1) / top_k                         # f_e
    mean_probs = probs.mean(dim=1)                                   # P_e
    lb_loss = (num_experts * torch.sum(frac_tokens * mean_probs, dim=-1)).mean()
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)), dim=-1).mean()

    # --- dispatch ---------------------------------------------------------
    tk = t * top_k
    capacity = max(1, math.ceil(t * top_k / num_experts * capacity_factor))
    n_slots = num_experts * capacity                                  # + 1 dump row
    order, slot, valid = _dispatch(top_idx.reshape(groups, tk), num_experts, capacity)
    sorted_gate = torch.gather(gates.reshape(groups, tk), -1, order)
    base = torch.arange(groups, device=dev)[:, None]
    gslot = (slot + base * (n_slots + 1)).reshape(-1)                 # rows of all groups
    gorder = (order + base * tk).reshape(-1)

    # Each token repeated top_k times in flat order, then permuted to the
    # sorted order: every row read once, so the backward adds nothing twice.
    xrep = xf.unsqueeze(2).expand(groups, t, top_k, d).reshape(groups * tk, d)
    vals = xrep.index_select(0, gorder) * valid.reshape(-1, 1).to(x.dtype)
    buf = torch.zeros((groups * (n_slots + 1), d), dtype=x.dtype, device=dev)
    buf = buf.index_put((gslot,), vals)          # distinct rows but the zero dump row
    xe = buf.reshape(groups, n_slots + 1, d)[:, :-1].reshape(groups, num_experts, capacity, d)
    xe = xe.transpose(0, 1).reshape(num_experts, groups * capacity, d)

    # --- expert FFN ---------------------------------------------------------
    h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wi)
    ye = torch.bmm(h, wo)                                            # (E, G*C, D)

    # --- combine -----------------------------------------------------------
    ye = ye.reshape(num_experts, groups, capacity, d).transpose(0, 1)
    ye_flat = torch.cat([ye.reshape(groups, n_slots, d),
                         torch.zeros((groups, 1, d), dtype=ye.dtype, device=dev)], dim=1)
    y_tok = ye_flat.reshape(-1, d).index_select(0, gslot)
    y_tok = y_tok * sorted_gate.reshape(-1, 1).to(ye.dtype)
    # Each token's top_k outputs in expert-sorted order: the sorted
    # positions of its assignments, ascending.
    inv = torch.argsort(order, dim=-1)
    pos = torch.sort(inv.reshape(groups, t, top_k), dim=-1).values
    contrib = y_tok.index_select(0, (pos + base[..., None] * tk).reshape(-1))
    contrib = contrib.reshape(groups * t, top_k, d)
    out = contrib[:, 0]
    for j in range(1, top_k):
        out = out + contrib[:, j]
    return out.reshape(b, s, d).to(x.dtype), lb_loss, z_loss


def moe_block(x: torch.Tensor, params: dict, *, top_k: int, capacity_factor: float = 1.25,
              router_style: str = "topk_softmax", group_rows: bool = False,
              ctx=None) -> MoEOutput:
    """Apply the MoE FFN. params: router (D, E), wi/wg (E, D, F), wo (E, F, D).

    The reference's mesh-free path; ``group_rows`` routes each row of ``x``
    alone (see the module doc). With a tensor-parallel ``ctx``, ``x`` is
    the whole sequence of the rank's rows, the expert weights are the
    rank's ``d_ff`` shards and ``y`` is its partial sum (see the module
    doc).
    """
    tp = ctx is not None and ctx.tensor_parallel
    if tp and group_rows:
        raise ValueError("row-grouped routing (serving) is single-device")
    y, lb, zl = _local_moe(
        x, params["router"], params["wi"], params["wg"], params["wo"],
        top_k=top_k, capacity_factor=capacity_factor, router_style=router_style,
        group_rows=group_rows,
    )
    if tp:
        from repro_torch.distributed import tensor_parallel

        lb, zl = tensor_parallel.replica_mean(lb, ctx), tensor_parallel.replica_mean(zl, ctx)
    return MoEOutput(y, lb, zl)


__all__ = ["MoEOutput", "moe_block"]
