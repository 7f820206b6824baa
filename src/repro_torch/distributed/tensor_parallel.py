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
* :func:`enter_whole` and :func:`leave_whole` -- into and out of a
  sub-block whose weights are whole on every rank (``ShardCtx.runs_whole``:
  no layout for Q, a ``d_ff``, expert ``d_ff``, ``d_inner`` or vocab that
  the axis does not divide). Every rank computes it whole and alike on the
  whole sequence, and keeps its own sequence shard of the output: the
  sequence-sharded residual all-gathered in, and its slice taken out, no
  reduce. Each is the other's transpose for a value the ranks compute
  alike: the backward of :func:`leave_whole` all-gathers the shards'
  cotangents, so every rank backpropagates the same whole cotangent, and
  :func:`enter_whole`'s takes the rank's slice of the same whole result.
  The weights' gradients come out whole on every rank, with no sum over
  ``model``. Without sequence sharding both are the identity;
* :func:`gather_cols` -- the Q and K/V projection columns of the 'hd'
  layout, and the SSM's convolved ``x`` where its heads stay whole, all-
  gathered over ``model``, reduce-scattered in the backward;
* :func:`sum_over_model` -- the SSM's gated-norm statistic: each rank's
  ``(rows, S, 1)`` fp32 sum of squares over its ``d_inner`` slice,
  all-reduced into the sum over the whole ``d_inner``. Its backward is an
  all-reduce too: every rank normalizes its own columns by the sum, so
  each rank's cotangent of it differs, and a rank's slice reaches all of
  them;
* :func:`replica_mean` -- the mean over ``model`` of a value every rank
  computes identically from the same gathered input (the MoE router's aux
  losses): the copies are equal, so the forward is the value itself, and
  the transpose gives each copy ``1/m`` of the cotangent, as JAX's
  shard_map transpose does for an output replicated over an axis. Without
  it, the sums over ``model`` that follow (the gathered input's
  reduce-scatter, the router gradient's sum) would count the aux
  gradient ``m`` times;
* :func:`embed_lookup` -- the vocab-parallel lookup: tokens outside the
  rank's rows give zeros, and :func:`reduce_seq` sums the partial rows (a
  VLM's vision rows ahead of them, on model index 0 only);
* :func:`gather_over_model` and :func:`merge_softmax` -- prefill's and
  decode's (no backward): K/V heads or head_dim slices all-gathered over
  ``model``, and the merge of each rank's partial softmax over its shard
  of the cache's keys (the sequence split over ``model`` or the data axes);
* :func:`cross_entropy` -- the masked mean cross entropy over the rank's
  ``Vp / model`` logits: the global max, the log-sum-exp and the label
  logit each through one all-reduce over ``model``. Pad columns stay in
  the log-sum-exp, as in the reference's CE over ``Vp``. Its backward
  (softmax minus one-hot) is local.

``ctx`` is a ``sharding.specs.ShardCtx`` whose ``comm`` is the mesh's
``Collectives``.

In train mode each decoder layer is checkpointed
(``models.transformer.forward(remat=True)``): the backward runs the layer's
forward again before its own backward, so the forward collectives of the
functions above that a layer calls recur once a layer, on every rank in
the same order (``plan.tp_bytes`` counts them). The embedding, the logits'
gather, the cross entropy and whisper's encoder are not checkpointed.
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


def _seq_slice(x: torch.Tensor, ctx) -> torch.Tensor:
    n = x.shape[SEQ_DIM] // ctx.size
    return x.narrow(SEQ_DIM, ctx.index * n, n)


class _EnterWhole(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return _all_gather(x, ctx, SEQ_DIM) if ctx.seq_shard else x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        ctx = fctx.ctx
        return (_seq_slice(g, ctx).contiguous() if ctx.seq_shard else g), None


class _LeaveWhole(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return _seq_slice(x, ctx).contiguous() if ctx.seq_shard else x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        ctx = fctx.ctx
        return (_all_gather(g.contiguous(), ctx, SEQ_DIM) if ctx.seq_shard else g), None


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return _all_gather(x, ctx, -1)

    @staticmethod
    def backward(fctx, g):
        return _reduce_scatter(g, fctx.ctx, -1), None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return _all_reduce(x, ctx)

    @staticmethod
    def backward(fctx, g):
        return _all_reduce(g, fctx.ctx), None


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


def enter_whole(x: torch.Tensor, ctx) -> torch.Tensor:
    """(B, S/m, D) -> (B, S, D) into a whole sub-block; see the module doc."""
    return _EnterWhole.apply(x, ctx)


def leave_whole(x: torch.Tensor, ctx) -> torch.Tensor:
    """A whole sub-block's (B, S, D) output -> the rank's (B, S/m, D) shard
    of it when sequence-sharded; see the module doc."""
    return _LeaveWhole.apply(x, ctx)


def gather_cols(x: torch.Tensor, ctx) -> torch.Tensor:
    """(..., n/m) -> (..., n): every rank's columns, in rank order."""
    return _GatherCols.apply(x, ctx)


def gather_over_model(x: torch.Tensor, ctx, dim: int) -> torch.Tensor:
    """Every rank's ``x`` over ``model``, concatenated along ``dim`` in rank
    order, without a backward: prefill and decode run no gradient. The
    'head' layout's K/V heads of a prefill whose cache splits its sequence
    over ``model`` (dim 2), and the cache's head_dim slices in the 'hd'
    layout, each decode step (dim -1)."""
    return _all_gather(x, ctx, dim)


def merge_softmax(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, ctx,
                  axes) -> torch.Tensor:
    """The attention output from each rank's partial softmax over its shard
    of the keys (``layers._partial_attention``: fp32 running max ``m`` and
    sum ``l`` (..., ) and accumulator ``acc`` (..., hd)), the shards split
    over ``axes``: the max over the axes (an all-reduce with ``max``),
    then each rank's sum and accumulator rescaled by ``exp(m - max)`` and
    summed over the axes in one all-reduce of (..., hd + 1), and
    ``acc / max(l, 1e-30)``, as :func:`layers.attention` ends. The direct
    softmax over every key, up to summation order."""
    comm = ctx.comm
    top = comm.all_reduce(m.clone(), axes, phase=PHASE, op="max")
    corr = torch.exp(m - top)[..., None]
    packed = comm.all_reduce(torch.cat([acc * corr, l[..., None] * corr], dim=-1), axes,
                             phase=PHASE)
    return packed[..., :-1] / torch.clamp(packed[..., -1:], min=1e-30)


def sum_over_model(x: torch.Tensor, ctx) -> torch.Tensor:
    """The sum over ``model`` of every rank's partial ``x``, on every rank
    (see the module doc)."""
    return _SumOverModel.apply(x, ctx)


def replica_mean(x: torch.Tensor, ctx) -> torch.Tensor:
    """The mean over ``model`` of ``x``, which every rank holds identically
    (see the module doc): ``x`` itself, its gradient divided by ``m``."""
    return _ReplicaMean.apply(x, ctx)


# Leaves every rank holds whole, in a sub-block the axis splits, whose
# gradient on a rank covers only its heads or columns, in either residual
# layout: the MoE router (it sees the rank's d_ff slice of the experts'
# output); the SSM's B/C projections and convs (read by the rank's heads
# only), its gate_norm (applied to the rank's d_inner slice); hymba's branch
# scales (on the rank's partial sums); the K/V projections beside Q heads
# that split (each rank reads the K/V heads of its own Q heads).
PARTIAL_IN_EITHER_LAYOUT = frozenset({
    "router", "wb", "wc", "conv_b", "conv_b_bias", "conv_c", "conv_c_bias", "gate_norm",
    "attn_scale", "ssm_scale", "wk", "wv"})
# The SSM's per-head leaves: split with the heads where their count divides
# the model axis; whole on every rank otherwise (``sharding.specs.
# ssm_heads_split``), where each rank runs every head but keeps its own
# d_inner columns of the output, so its gradient comes from those columns.
PARTIAL_WHEN_WHOLE = frozenset({"wdt", "A_log", "D", "dt_bias"})


def grad_is_partial(key, model_split: bool, ctx) -> bool:
    """Whether a rank's gradient of the leaf ``key`` is a part of the whole
    that the ranks of ``model`` sum, decided from what is whole on the mesh:

    * a leaf ``model`` splits (``model_split``, read from the parameter's
      spec): never;
    * hymba's whole branch beside a split one (``ctx.whole_on_index0``):
      always, since it enters the partial sum on model index 0 alone;
    * a leaf of a sub-block every rank computes whole
      (``ctx.runs_whole``: :func:`enter_whole` / :func:`leave_whole`):
      never, in either layout;
    * otherwise a leaf ``model`` does not split, when its residual is
      sequence-sharded (it saw the rank's sequence shard only), and in
      either layout the leaves of :data:`PARTIAL_IN_EITHER_LAYOUT` (the MoE
      router beside split experts; the SSM's ``wb``, ``wc``, ``conv_b``,
      ``conv_b_bias``, ``conv_c``, ``conv_c_bias`` and ``gate_norm`` beside
      a split ``d_inner``; hymba's ``attn_scale`` and ``ssm_scale`` beside a
      split branch; ``wk`` and ``wv`` whole beside split Q heads) and the
      SSM's ``wdt``, ``A_log``, ``D`` and ``dt_bias`` whole beside a split
      ``d_inner`` (:data:`PARTIAL_WHEN_WHOLE`).

    A leaf under ``encoder/`` (whisper's) lives on the encoder's residual,
    which follows its own length (``ctx.encoder_seq_shard``); every other
    leaf, the decoder's ``cross_norm`` among them, on the decoder's."""
    if model_split:
        return False
    if len(key) > 1 and key[-2] in ctx.whole_on_index0:
        return True
    if ctx.runs_whole(key):
        return False
    seq_shard = ctx.encoder_seq_shard if key[0] == "encoder" else ctx.seq_shard
    return (seq_shard or key[-1] in PARTIAL_IN_EITHER_LAYOUT
            or key[-1] in PARTIAL_WHEN_WHOLE)


def vocab_range(rows: int, ctx) -> tuple[int, int]:
    """The first and past-the-last vocab id of the rank's ``rows``."""
    return ctx.index * rows, (ctx.index + 1) * rows


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor, ctx, *, scale=None,
                 prefix=None) -> torch.Tensor:
    """The vocab-parallel embedding: ``embed`` is the rank's (Vp/m, D) rows;
    returns the summed (B, S/m, D) rows (or (B, S, D) unsharded), each
    times ``scale`` where given. ``prefix`` (B, V, D), a VLM's vision
    embeddings, goes ahead of the text before the sum, so that the shards
    are cut from the whole ``V + S`` sequence: model index 0 adds it, the
    other ranks zeros, and the sum is exact."""
    lo, hi = vocab_range(embed.shape[0], ctx)
    inside = (tokens >= lo) & (tokens < hi)
    rows = embed[(tokens - lo).clamp(0, embed.shape[0] - 1)].masked_fill(~inside[..., None], 0)
    if scale is not None:
        # A fill on the device: a host scalar copied over would sync the host.
        rows = rows * torch.full((), scale, dtype=rows.dtype, device=rows.device)
    if prefix is not None:
        prefix = prefix.to(rows.dtype)
        if ctx.index:
            prefix = torch.zeros_like(prefix)
        rows = torch.cat([prefix, rows], dim=SEQ_DIM)
    return reduce_seq(rows, ctx)


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
