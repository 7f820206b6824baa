"""The collectives of the tensor-parallel model, as autograd functions.

The reference's model is tensor-parallel under GSPMD, which inserts these
collectives from the parameter and activation shardings
(``repro/sharding/specs.py``, ``_seq_shard`` in ``repro/models/
transformer.py``); eager PyTorch issues them itself. Each function below
runs its collectives through ``distributed.audit.Collectives`` under the
trace phase ``'tp'`` and is its own backward's transpose, so a rank's
gradients come out in the parameter layout (Megatron-LM's f/g operators,
with its sequence parallelism):

* :func:`gather_seq` -- into a layer's attention or MLP (and the logits):
  the sequence-sharded residual all-gathered over ``model`` on its sequence
  dim, reduce-scattered in the backward. Without sequence sharding it is
  the identity, and its backward all-reduces (every rank's partial
  gradient of the replicated input);
* :func:`reduce_seq` -- out of the row-parallel ``wo``, the MoE block
  (each rank's expert output over its ``d_ff`` slice, after the combine)
  and the vocab-parallel embedding: the partial sums reduce-scattered on
  the sequence dim, all-gathered in the backward; without sequence
  sharding an all-reduce, and the identity in the backward;
* :func:`gather_cols` -- the K/V projection columns of the 'hd' layout
  all-gathered over ``model``, reduce-scattered in the backward;
* :func:`replica_mean` -- the mean over ``model`` of a value every rank
  computes identically from the same gathered input (the MoE router's aux
  losses): the copies are equal, so the forward is the value itself, and
  the transpose gives each copy ``1/m`` of the cotangent, as JAX's
  shard_map transpose does for an output replicated over an axis. Without
  it, the sums over ``model`` that follow (the gathered input's
  reduce-scatter, the router gradient's sum) would count the aux
  gradient ``m`` times;
* :func:`embed_lookup` -- the vocab-parallel lookup: tokens outside the
  rank's rows give zeros, and :func:`reduce_seq` sums the partial rows;
* :func:`cross_entropy` -- the masked mean cross entropy over the rank's
  ``Vp / model`` logits: the global max, the log-sum-exp and the label
  logit each through one all-reduce over ``model``. Pad columns stay in
  the log-sum-exp, as in the reference's CE over ``Vp``. Its backward
  (softmax minus one-hot) is local.

``ctx`` is a ``sharding.specs.ShardCtx`` whose ``comm`` is the mesh's
``Collectives``.
"""

from __future__ import annotations

import torch

PHASE = "tp"
SEQ_DIM = 1


def _all_reduce(x: torch.Tensor, ctx) -> torch.Tensor:
    return ctx.comm.all_reduce(x.clone(), ctx.model_axes, phase=PHASE)


def _reduce_scatter(x: torch.Tensor, ctx, dim: int) -> torch.Tensor:
    return ctx.comm.reduce_scatter(x, ctx.model_axes, dim=dim, phase=PHASE)


def _all_gather(x: torch.Tensor, ctx, dim: int) -> torch.Tensor:
    return ctx.comm.all_gather(x, ctx.model_axes, dim=dim, phase=PHASE)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return _all_gather(x, ctx, SEQ_DIM) if ctx.seq_shard else x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        ctx = fctx.ctx
        return (_reduce_scatter(g, ctx, SEQ_DIM) if ctx.seq_shard else _all_reduce(g, ctx)), None


class _ReduceSeq(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return _reduce_scatter(x, ctx, SEQ_DIM) if ctx.seq_shard else _all_reduce(x, ctx)

    @staticmethod
    def backward(fctx, g):
        ctx = fctx.ctx
        return (_all_gather(g, ctx, SEQ_DIM) if ctx.seq_shard else g), None


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return _all_gather(x, ctx, -1)

    @staticmethod
    def backward(fctx, g):
        return _reduce_scatter(g, fctx.ctx, -1), None


class _ReplicaMean(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.size = ctx.size
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return g / fctx.size, None


def gather_seq(x: torch.Tensor, ctx) -> torch.Tensor:
    """(B, S/m, D) -> (B, S, D) when sequence-sharded; see the module doc."""
    return _GatherSeq.apply(x, ctx)


def reduce_seq(x: torch.Tensor, ctx) -> torch.Tensor:
    """Partial (B, S, D) -> summed (B, S/m, D), or (B, S, D) unsharded."""
    return _ReduceSeq.apply(x, ctx)


def gather_cols(x: torch.Tensor, ctx) -> torch.Tensor:
    """(..., n/m) -> (..., n): every rank's columns, in rank order."""
    return _GatherCols.apply(x, ctx)


def replica_mean(x: torch.Tensor, ctx) -> torch.Tensor:
    """The mean over ``model`` of ``x``, which every rank holds identically
    (see the module doc): ``x`` itself, its gradient divided by ``m``."""
    return _ReplicaMean.apply(x, ctx)


def grad_is_partial(key, model_split: bool, ctx) -> bool:
    """Whether a rank's gradient of the leaf ``key`` is a part of the whole
    that the ranks of ``model`` sum: a leaf ``model`` does not split, when
    the residual is sequence-sharded (it saw the rank's sequence shard
    only), and the MoE router in either layout (it saw only the rank's
    ``d_ff`` slice of the experts' output)."""
    return not model_split and (ctx.seq_shard or key[-1] == "router")


def vocab_range(rows: int, ctx) -> tuple[int, int]:
    """The first and past-the-last vocab id of the rank's ``rows``."""
    return ctx.index * rows, (ctx.index + 1) * rows


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor, ctx) -> torch.Tensor:
    """The vocab-parallel embedding: ``embed`` is the rank's (Vp/m, D) rows;
    returns the summed (B, S/m, D) rows (or (B, S, D) unsharded)."""
    lo, hi = vocab_range(embed.shape[0], ctx)
    inside = (tokens >= lo) & (tokens < hi)
    rows = embed[(tokens - lo).clamp(0, embed.shape[0] - 1)]
    return reduce_seq(rows.masked_fill(~inside[..., None], 0), ctx)


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(fctx, logits, labels, ignore, ctx):
        comm, axes = ctx.comm, ctx.model_axes
        local = logits.to(torch.float32)
        vl = local.shape[-1]
        gmax = comm.all_reduce(local.amax(dim=-1), axes, phase=PHASE, op="max")
        shifted = local - gmax[..., None]
        sumexp = comm.all_reduce(torch.exp(shifted).sum(dim=-1), axes, phase=PHASE)
        lse = gmax + torch.log(sumexp)
        lo, hi = vocab_range(vl, ctx)
        target = labels.clamp(min=0)
        inside = (target >= lo) & (target < hi)
        ids = (target - lo).clamp(0, vl - 1)
        picked = torch.gather(local, -1, ids[..., None])[..., 0]
        label_logit = comm.all_reduce(torch.where(inside, picked, torch.zeros_like(picked)),
                                      axes, phase=PHASE)
        mask = (labels != ignore).to(torch.float32)
        count = torch.clamp(mask.sum(), min=1.0)
        fctx.save_for_backward(local, lse, ids, inside, mask, count)
        fctx.dtype = logits.dtype
        return torch.sum((lse - label_logit) * mask) / count

    @staticmethod
    def backward(fctx, g):
        local, lse, ids, inside, mask, count = fctx.saved_tensors
        grad = torch.exp(local - lse[..., None])
        grad.scatter_add_(-1, ids[..., None], -inside.to(grad.dtype)[..., None])
        grad.mul_((g * mask / count)[..., None])
        return grad.to(fctx.dtype), None, None, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ctx,
                  ignore: int = -1) -> torch.Tensor:
    """Masked mean CE of the rank's (B, S, Vp/m) logits against the (B, S)
    labels (``ignore`` masked): the same value on every rank of the group."""
    return _VocabParallelCE.apply(logits, labels, ignore, ctx)
