"""Communication planner: predicted collectives of the MuonBP update.

Counterpart of ``repro/distributed/plan.py``, pure math on axis sizes: it
reads an ``{axis: size}`` dict (or a ``DeviceMesh``, through
``sharding.specs.mesh_axis_sizes``), never a live group. The paper's
systems claim (Sec 3.2) is a statement about the optimizer's communication
schedule: block steps touch only shard-local data (zero optimizer
collectives), full steps pay one momentum gather per sharded matrix. Given
the parameter specs of ``sharding/specs.py`` this module emits a per-leaf
:class:`LeafCommPlan` and a :class:`CommPlan` with a ``predicted_bytes``
accounting API; ``distributed/audit.py`` holds the engine's collective
trace against it.

Byte convention: the predicted bytes of a collective are the bytes of its
per-rank **result** buffer. All NS inputs are fp32 (the momentum dtype),
hence 4 bytes an element.

Three accounted phases:

  * ``'block'``  -- block-periodic step. Shard-local by construction: every
    NS unit is a rank's own shard, so the plan predicts zero collectives
    (a sharded leaf with no usable block grid is the exception: it is
    orthogonalized whole and pays the gather every step).
  * ``'full'``   -- periodic full orthogonalization. Per sharded muon leaf:
    all-gather the momentum shards over the trailing-dim model axes, run
    the full NS redundantly, slice the local shard back out (local).
  * ``'apply'``  -- ZeRO-1 only: updates leave the optimizer sharded over
    the data axes on the leading stack dim, and bringing them to the
    data-replicated param layout costs one all-gather a leaf and step
    (still model-sharded on the trailing dims). The flatten fallback
    (``sharding.specs.zero1_flatten_info``) is priced here too, as per-axis
    gathers of the padded update stack.

Every :class:`Collective` records the mesh axes it runs over; each axis has
a modeled link class, ``'ici'`` within a pod and ``'dcn'`` for the
inter-pod ``'pod'`` axis. The modeled rates below are the reference's
planning constants (a TPU's interconnect and MXU): they order the pipeline
schedule's buckets and price its overlap, and are no measurement of any
device this port runs on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

from repro_torch import tree as tree_lib
from repro_torch.core.blocking import block_spec_from_partition
from repro_torch.core.combine import default_label_fn
from repro_torch.sharding import specs as sh
from repro_torch.sharding.specs import spec_entry_names as _names
from repro_torch.sharding.specs import spec_entry_size as _factor

PHASES = ("block", "full", "apply")
FP32_BYTES = 4

# Virtual phase name for the staggered full-step schedule: each muon leaf
# carries a residue offset in [0, period) and goes full only on steps where
# ``step % period == offset``; every other step it runs its block phase.
# Priced via ``CommPlan.predicted_bytes('staggered', period=, residue=)`` —
# per leaf, the 'full' collectives iff the leaf is due at that residue,
# else its 'block' collectives. Offsets come from
# :func:`assign_stagger_offsets`, the same greedy balancer the program
# compiler uses, so plan and executable agree leaf-for-leaf.
STAGGERED = "staggered"

# Modeled ratios for pipeline-schedule pricing (program.py's
# PipelineSchedule), the reference's planning constants: modeling values,
# not a measurement of any device (the collective trace measures bytes).
# A collective over the inter-pod 'pod' axis is modeled at 1/8 of the
# intra-pod rate, the ratio that makes "largest inter-pod gather first"
# the schedule order.
MODELED_ICI_BYTES_PER_S = 50e9
MODELED_NS_FLOPS_PER_S = 100e12

# Mesh axes that traverse the inter-pod (DCN) link; everything else is ICI.
DCN_AXES = ("pod",)
LINKS = ("ici", "dcn")
MODELED_LINK_BYTES_PER_S = {
    "ici": MODELED_ICI_BYTES_PER_S,
    "dcn": MODELED_ICI_BYTES_PER_S / 8,
}


def link_class(axes) -> str:
    """Link a collective over ``axes`` traverses: 'dcn' iff any inter-pod axis.

    A collective whose replica groups span the pod boundary is bottlenecked
    by the slowest link regardless of how many intra-pod hops it also makes,
    so one DCN axis makes the whole collective 'dcn'.
    """
    return "dcn" if any(a in DCN_AXES for a in axes) else "ici"


def assign_stagger_offsets(
    items, period: int
) -> dict:
    """Balance leaves across ``period`` step-residues by per-step DCN bytes.

    THE single source of the stagger offset assignment — ``CommPlan``
    pricing, the ``core/program.py`` compiler, and the run-metadata
    snapshot all call this, so the plan, the compiled per-residue
    programs, and the checkpointed schedule cannot disagree on which leaf
    is due when. ``items`` are ``(key, dcn_bytes, total_bytes)`` triples
    (one per leaf that participates in the stagger — muon matrices);
    ``key`` is the canonical 'a/b/c' path string.

    Greedy LPT on a lexicographic cost: leaves sorted by
    ``(-dcn, -total, key)`` each go to the residue with the smallest
    ``(dcn_load, total_load, count, residue)`` — largest inter-pod
    gathers placed first, ICI bytes as tie-break, leaf count last so
    zero-byte leaves still spread evenly. Deterministic by construction
    (pure sort + argmin, no hashing), which is what makes the offsets
    safe to persist in run metadata and compare bit-exactly on resume.
    """
    period = int(period)
    if period < 2:
        raise ValueError(f"stagger period must be >= 2, got {period}")
    loads = [[0, 0, 0] for _ in range(period)]
    offsets: dict = {}
    for key, dcn, total in sorted(items, key=lambda t: (-t[1], -t[2], t[0])):
        r = min(range(period),
                key=lambda i: (loads[i][0], loads[i][1], loads[i][2], i))
        offsets[key] = r
        loads[r][0] += int(dcn)
        loads[r][1] += int(total)
        loads[r][2] += 1
    return offsets


@dataclasses.dataclass(frozen=True)
class Collective:
    """One predicted collective: op name, mesh axes, per-device result bytes."""

    op: str                 # 'all-gather' | 'reduce-scatter' | ...
    axes: tuple[str, ...]   # mesh axes it runs over
    bytes: int              # per-rank result-buffer bytes

    @property
    def link(self) -> str:
        return link_class(self.axes)


@dataclasses.dataclass(frozen=True)
class LeafCommPlan:
    """Predicted optimizer communication for one parameter leaf."""

    path: str
    shape: tuple
    spec: tuple                   # momentum spec (normalized to ndim)
    label: str                    # 'muon' | 'adamw' | ...
    zero1_factor: int             # data-axis shard factor on the lead dim
    block: tuple[Collective, ...]
    full: tuple[Collective, ...]
    apply: tuple[Collective, ...]
    flatten: Optional[Any] = None  # sharding.specs.FlattenSpec (fallback leaves)

    def collectives(self, phase: str) -> tuple[Collective, ...]:
        if phase not in PHASES:
            raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
        return getattr(self, phase)

    def predicted_bytes(self, phase: str, link: Optional[str] = None) -> int:
        return sum(
            c.bytes for c in self.collectives(phase)
            if link is None or c.link == link
        )


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """Per-leaf communication plan for one optimizer step on one mesh."""

    axis_sizes: dict[str, int]
    leaves: tuple[LeafCommPlan, ...]

    def stagger_leaves(self) -> tuple[LeafCommPlan, ...]:
        """Leaves that participate in the staggered schedule (muon matrices)."""
        return tuple(
            leaf for leaf in self.leaves
            if leaf.label == "muon" and len(leaf.shape) >= 2
        )

    def stagger_offsets(self, period: int) -> dict[str, int]:
        """Per-leaf residue offsets (path -> r) balancing per-step DCN bytes.

        Same items/keys/tie-breaks as the program compiler (both call
        :func:`assign_stagger_offsets` over the muon matrices' full-step
        gather bytes), so ``predicted_bytes('staggered', ...)`` prices the
        exact program each residue executes.
        """
        return assign_stagger_offsets(
            ((leaf.path, leaf.predicted_bytes("full", "dcn"),
              leaf.predicted_bytes("full"))
             for leaf in self.stagger_leaves()),
            period,
        )

    def _staggered_leaf_phase(self, period: int, residue: int):
        """Yield ``(leaf, phase)`` for one residue of the staggered schedule."""
        if period is None:
            raise ValueError("phase='staggered' requires period=")
        residue = int(residue) % int(period)
        offsets = self.stagger_offsets(period)
        for leaf in self.leaves:
            due = offsets.get(leaf.path) == residue
            yield leaf, ("full" if due else "block")

    def predicted_bytes(self, phase: str, link: Optional[str] = None, *,
                        period: Optional[int] = None,
                        residue: Optional[int] = None) -> int:
        if phase == STAGGERED:
            return sum(
                leaf.predicted_bytes(ph, link)
                for leaf, ph in self._staggered_leaf_phase(period, residue or 0)
            )
        return sum(leaf.predicted_bytes(phase, link) for leaf in self.leaves)

    def staggered_bytes_by_residue(
        self, period: int, link: Optional[str] = None
    ) -> tuple[int, ...]:
        """Per-residue predicted bytes of one staggered step, r = 0..period-1."""
        return tuple(
            self.predicted_bytes(STAGGERED, link, period=period, residue=r)
            for r in range(int(period))
        )

    def max_staggered_dcn_bytes(self, period: int) -> int:
        """Max-over-residues exposed inter-pod bytes of one staggered step.

        The headline stagger metric: the worst single step's DCN bill.
        Balanced offsets make this ~``predicted_bytes('full', 'dcn') /
        period`` (within one leaf of imbalance) instead of the synchronous
        schedule's full bill every p-th step.
        """
        return max(self.staggered_bytes_by_residue(period, "dcn"))

    def predicted(self, phase: str) -> dict[str, dict[str, int]]:
        """Aggregate {op: {count, bytes}} — the shape parse_collectives emits."""
        out: dict[str, dict[str, int]] = {}
        for leaf in self.leaves:
            for c in leaf.collectives(phase):
                rec = out.setdefault(c.op, {"count": 0, "bytes": 0})
                rec["count"] += 1
                rec["bytes"] += c.bytes
        return out

    def predicted_by_link(self, phase: str) -> dict[str, int]:
        """Bytes per modeled link class — {'ici': ..., 'dcn': ...}."""
        return {link: self.predicted_bytes(phase, link) for link in LINKS}

    def predicted_by_axes(self, phase: str, *,
                          period: Optional[int] = None,
                          residue: Optional[int] = None
                          ) -> dict[tuple[str, ...], int]:
        """Bytes per (sorted) mesh-axis set a collective traverses.

        The same keying ``audit.bytes_by_axes`` derives from post-SPMD
        trace events, so per-axis plan-vs-trace comparison is direct.
        ``phase='staggered'`` (with ``period=``/``residue=``) prices one
        residue of the staggered schedule leaf-by-leaf.
        """
        if phase == STAGGERED:
            pairs = self._staggered_leaf_phase(period, residue or 0)
        else:
            pairs = ((leaf, phase) for leaf in self.leaves)
        out: dict[tuple[str, ...], int] = {}
        for leaf, ph in pairs:
            for c in leaf.collectives(ph):
                key = tuple(sorted(c.axes))
                out[key] = out.get(key, 0) + c.bytes
        return out

    def summary(self) -> str:
        lines = [f"CommPlan over mesh {self.axis_sizes}:"]
        for phase in PHASES:
            agg = self.predicted(phase)
            total = self.predicted_bytes(phase)
            dcn = self.predicted_bytes(phase, "dcn")
            link = f" (inter-pod {dcn} B)" if dcn else ""
            lines.append(
                f"  {phase:5s}: {total} B{link}  "
                f"{agg if agg else '(no collectives)'}"
            )
        return "\n".join(lines)


def trailing_gather_collectives(
    local_elems: int, entries, sizes: dict[str, int]
) -> tuple[tuple[str, tuple[str, ...], int], ...]:
    """Per-axis tiled all-gathers of the trailing (matrix) dims.

    THE single source of the trailing-gather pricing sequence — dim -2
    then -1, one collective per mesh AXIS (minor axis first within a
    tuple entry), per-device result bytes growing as each axis fills in —
    mirroring ``engine._gather_trailing`` event-for-event so per-axis
    audits compare exactly. ``entries`` are the (-2, -1) PartitionSpec
    entries; ``local_elems`` the fully-local element count. Returns
    ``(op, axes, bytes)`` tuples (the program CommOp convention; wrap in
    :class:`Collective` for plan records).
    """
    out = []
    local = local_elems
    for entry in entries:
        for name in reversed(_names(entry)):
            factor = sizes.get(name, 1)
            if factor > 1:
                local *= factor
                out.append(("all-gather", (name,), local * FP32_BYTES))
    return tuple(out)


def lead_gather_collectives(
    local_lead: int, trailing_elems: int, axes, sizes: dict[str, int]
) -> tuple[tuple[str, tuple[str, ...], int], ...]:
    """Per-axis tiled all-gathers restoring a ZeRO-sharded lead dim.

    THE single source of the flatten-fallback writeback pricing — one
    collective per ZeRO axis, minor axis first (mirroring the engine's
    writeback), result bytes growing as the padded lead dim fills in with
    the trailing dims still model-sharded (``trailing_elems`` local
    elements per layer). Shared by ``_plan_leaf`` and
    ``core/program.py``'s compiler so plan, program, and the measured trace
    cannot drift.
    """
    out = []
    acc = local_lead
    for name in reversed(tuple(axes)):
        if sizes.get(name, 1) > 1:
            acc *= sizes[name]
            out.append(("all-gather", (name,), acc * trailing_elems * FP32_BYTES))
    return tuple(out)


def _plan_leaf(path: str, shape: tuple, spec, label: str,
               sizes: dict[str, int], *, zero1: bool, zero1_axis,
               zero1_flatten: bool = False,
               block_spec=None, has_block_specs: bool = False) -> LeafCommPlan:
    flatten = (
        sh.zero1_flatten_info(spec, shape, sizes, zero1_axis=zero1_axis,
                              label=label)
        if zero1 and zero1_flatten else None
    )
    if flatten is not None:
        uspec = sh.flatten_momentum_spec(spec, shape, flatten)
        plan_shape = flatten.padded_shape(shape)
    else:
        uspec = sh.momentum_spec(spec, shape, sizes, zero1=zero1,
                                 zero1_axis=zero1_axis, label=label)
        plan_shape = tuple(shape)
    entries = list(uspec) + [None] * (len(shape) - len(uspec))
    pspec_entries = list(spec) if spec is not None else []
    pspec_entries += [None] * (len(shape) - len(pspec_entries))
    # ZeRO-1 factor = the data sharding momentum_spec ADDED on the lead dim
    # (a param already sharded there, e.g. vocab-parallel embed, is not it).
    zero1_added = bool(shape) and entries[0] != pspec_entries[0]
    d = _factor(entries[0], sizes) if zero1_added else 1
    elems = math.prod(shape) if shape else 1

    full: list[Collective] = []
    block: list[Collective] = []
    apply_: list[Collective] = []

    # Trailing-dim shard factors from the PARAM spec (the MuonBP block grid
    # for muon leaves; for 2-D AdamW leaves the momentum's ZeRO-1 lead-dim
    # sharding coincides with dim -2 and must not count as a trailing factor).
    r = _factor(pspec_entries[-2], sizes) if len(shape) >= 2 else 1
    c = _factor(pspec_entries[-1], sizes) if len(shape) >= 1 else 1

    if label == "muon" and len(shape) >= 2:
        if r * c > 1:
            # Full step: the canonical trailing-gather sequence (see
            # trailing_gather_collectives); the final slice-back is local.
            local = math.prod(sh.local_shape(uspec, plan_shape, sizes)) or 1
            full += [
                Collective(*t) for t in trailing_gather_collectives(
                    local, (pspec_entries[-2], pspec_entries[-1]), sizes
                )
            ]
            # Block step: zero collectives iff the leaf HAS a usable block
            # grid; an unblocked-but-sharded leaf is orthogonalized fully
            # every step and pays the same gathers (the engine's condition).
            # The grid is the optimizer's actual block_specs entry when the
            # caller passed the tree, else re-derived from the layout.
            bs = (
                block_spec
                if has_block_specs
                else block_spec_from_partition(uspec, plan_shape, sizes)
            )
            if bs is None or bs.num_blocks == 1:
                block = list(full)

    if flatten is not None:
        # Flatten-fallback writeback: the padded update stack re-enters the
        # param layout through per-axis gathers (canonical sequence in
        # lead_gather_collectives). The pad slice after is local.
        loc = sh.local_shape(uspec, plan_shape, sizes)
        trailing_elems = math.prod(loc[1:]) if len(loc) > 1 else 1
        apply_ += [
            Collective(*t) for t in lead_gather_collectives(
                loc[0], trailing_elems, flatten.axes, sizes
            )
        ]
    elif d > 1:
        # ZeRO-1 apply-time gather: updates are data-sharded on the lead
        # dim; params are data-replicated. One all-gather per leaf per step
        # whose result stays model-sharded on the trailing dims (per-device
        # result bytes divide by the trailing shard factors).
        apply_.append(Collective(
            "all-gather", _names(entries[0]), elems // (r * c) * FP32_BYTES))

    return LeafCommPlan(
        path=path, shape=tuple(shape), spec=tuple(entries), label=label,
        zero1_factor=flatten.factor if flatten is not None else d,
        block=tuple(block), full=tuple(full), apply=tuple(apply_),
        flatten=flatten,
    )


def plan_comm(params: Any, pspecs: Any, mesh, *, labels: Any = None,
              block_specs: Any = None, zero1: bool = False,
              zero1_axis=None, zero1_flatten: bool = False) -> CommPlan:
    """Build the :class:`CommPlan` for one optimizer step.

    Args:
      params: param tree (tensors, or anything with ``.shape``: shapes only).
      pspecs: matching tree of spec tuples (``sharding.specs.param_specs``).
      mesh: ``{axis: size}`` or a ``DeviceMesh`` (only sizes are read).
      labels: optional tree of optimizer labels ('muon'/'adamw'); defaults
        to ``core.combine.default_label_fn`` applied per leaf.
      block_specs: optional tree of ``BlockSpec2D`` -- the tree handed to
        the optimizer. When given, block-step predictions use it (a muon
        leaf with no usable grid pays its full-step gathers every step, the
        engine's condition); when omitted the grid is re-derived from the
        layout (the standard blocks-follow-shards configuration).
      zero1: account ZeRO-1 momentum sharding (``sharding.specs.momentum_spec``).
      zero1_axis: axis name, tuple of names, or None for the data axes.
      zero1_flatten: price the flatten-and-shard fallback of leaves whose
        lead dim does not divide the ZeRO axes (padded lead split, per-axis
        writeback gathers in 'apply'), as ``make_engine(...,
        zero1_flatten=True)`` runs it.
    """
    sizes = sh.mesh_axis_sizes(mesh)
    zero1_axis = sh.zero1_axes(sizes, zero1_axis) if zero1 else zero1_axis
    flat_p = tree_lib.flatten_with_path(params)
    spec_by_path = dict(tree_lib.flatten_with_path(pspecs))
    if labels is not None:
        label_by_path = dict(tree_lib.flatten_with_path(labels))
    else:
        label_by_path = {path: default_label_fn(sh.path_str(path), leaf)
                         for path, leaf in flat_p}
    missing = [sh.path_str(p) for p, _ in flat_p
               if p not in spec_by_path or p not in label_by_path]
    if missing:
        raise ValueError(f"params/pspecs/labels trees differ at {missing[:5]}")
    bs_by_path = dict(tree_lib.flatten_with_path(block_specs)) if block_specs is not None else {}
    leaves = tuple(
        _plan_leaf(sh.path_str(path), tuple(leaf.shape), spec_by_path[path],
                   label_by_path[path], sizes, zero1=zero1, zero1_axis=zero1_axis,
                   zero1_flatten=zero1_flatten, block_spec=bs_by_path.get(path),
                   has_block_specs=block_specs is not None)
        for path, leaf in flat_p
    )
    return CommPlan(axis_sizes=sizes, leaves=leaves)


def dion_bytes(params: Any, pspecs: Any, mesh, *, labels: Any = None, rank: int = 64,
               zero1: bool = False, zero1_flatten: bool = False) -> int:
    """The ``'dion'`` collective bytes of one rank and optimizer step of
    Dion on a mesh (``core/dion.py``), from the shapes and the layout.

    Arguments as :func:`plan_comm`'s (ZeRO-1 over the data axes);
    ``rank`` is Dion's. A Muon-labelled
    leaf of momentum shard ``(..., m_s, n_s)`` (global ``m, n``, ``r =
    min(rank, m, n)``, the lead dims the rank's layers) pays, fp32 result
    buffers: with its columns split, the ``(m_s, r)`` all-reduce of ``P``
    and the ``(r,)`` all-reduce of ``R``'s column sums of squares; with its
    rows split, the ``(m, r)`` all-gather of ``P`` and the ``(n_s, r)``
    all-reduce of ``R``. A leaf split on neither pays nothing, and the
    factor program itself gathers nothing.
    """
    from repro_torch.distributed.engine import make_engine

    sizes = sh.mesh_axis_sizes(mesh)
    engine = make_engine(params, pspecs, sizes, zero1=zero1, zero1_flatten=zero1_flatten)
    flat_p = tree_lib.flatten_with_path(params)
    label_by_path = (dict(tree_lib.flatten_with_path(labels)) if labels is not None else
                     {path: default_label_fn(sh.path_str(path), leaf) for path, leaf in flat_p})
    total = 0
    for path, leaf in flat_p:
        if label_by_path[path] != "muon":
            continue
        state = engine.state_shape_for(path, tuple(leaf.shape))
        spec = engine.spec_for(path, len(state))
        local = engine.local_shape(path, state)
        lead = math.prod(local[:-2])
        m, n = state[-2], state[-1]
        r = min(rank, m, n)
        if sh.spec_entry_size(spec[-1], sizes) > 1:
            total += FP32_BYTES * lead * (local[-2] * r + r)
        if sh.spec_entry_size(spec[-2], sizes) > 1:
            total += FP32_BYTES * lead * (m * r + local[-1] * r)
    return total


def tp_bytes(cfg, rows: int, seq: int, axis_sizes, *, compute_bytes: int = 2,
             remat: bool = True, mode: str = "train", batch: Optional[int] = None,
             cache_len: Optional[int] = None, kv_seq_shard: bool = False) -> int:
    """The ``'tp'`` collective bytes of one rank and training step of the
    tensor-parallel model (``distributed/tensor_parallel.py``), from the
    shapes; 0 where ``sharding.specs.mesh_path`` runs ``cfg`` replicated.
    ``mode="prefill"`` and ``"decode"`` count one prefill and one decode
    step instead (:func:`_tp_serve_bytes`; ``batch``, ``cache_len`` and
    ``kv_seq_shard`` are its), on a mesh without a model split too.

    ``rows`` x ``seq`` text tokens a rank (its data coordinate's rows); the
    residual is ``sharding.specs.residual_len`` long (a VLM's vision tokens
    ahead of the text). Activations of ``compute_bytes`` an element, but
    whisper's encoder and its cross-attention K/V in fp32 (the frames are
    fp32 and promote, as in the reference); the replicated leaves'
    gradients fp32. Result-buffer bytes, as the plan's (a reduce-scatter's
    is the rank's slice). A split sub-block's sequence gather and reduce
    count with their backward: an all-gather and a reduce-scatter each way
    when its residual is sequence-sharded, else one all-reduce each way. A
    sub-block the axis leaves whole (``sharding.specs.whole_sub_blocks``;
    ``tensor_parallel.enter_whole`` / ``leave_whole``) moves one all-gather
    each way when sequence-sharded, else nothing. Counted:

    * each layer's branches: the attention (hymba's attention and SSM
      together, mamba2's SSM), whisper's cross-attention, then the MLP or
      MoE block; an encoder layer's two at ``rows x encoder_seq`` under the
      encoder's own rule;
    * on the 'hd' layouts, the column gathers and their reduce-scatters:
      K and V's (of the encoder output, for the cross-attention), and Q's;
    * on an SSM or hybrid layer whose ``d_inner`` splits and whose heads
      stay whole (``sharding.specs.ssm_heads_split``), the gather of the
      convolved ``(rows, S, d_inner)`` input and its reduce-scatter;
    * whisper's encoder output, gathered once, and its backward (the
      reduce of the partial cotangents; none with whole heads);
    * a split SSM layer's gated-norm statistic: a (rows, S) fp32
      all-reduce forward and another backward;
    * the embedding and the logits' gather (the whole residual); the
      vocab-parallel cross entropy's three (rows, S) fp32 all-reduces
      (text only), none with the vocab whole;
    * the sum over the model axis of the gradients
      ``tensor_parallel.grad_is_partial`` names, counted leaf by leaf from
      the parameters' shapes (fake tensors, nothing allocated);
    * with ``remat`` (the default, as ``models.transformer.forward``'s),
      each decoder layer's forward collectives once more, in the backward's
      recompute (whisper's encoder and the gather of its output are not
      checkpointed).
    """
    sizes = sh.mesh_axis_sizes(axis_sizes)
    if mode != "train":
        return _tp_serve_bytes(cfg, rows, seq, sizes, mode=mode, batch=batch,
                               cache_len=cache_len, kv_seq_shard=kv_seq_shard,
                               compute_bytes=compute_bytes)
    if sh.mesh_path(cfg, sizes) != sh.TENSOR_PARALLEL:
        return 0
    m = sizes[sh.MODEL_AXIS]
    (edge_f, edge_b), (layer_f, layer_b), (enc_f, enc_b) = _tp_forward(cfg, rows, seq, m,
                                                                       compute_bytes)
    total = (edge_f + edge_b + cfg.num_layers * (layer_f + layer_b + (layer_f if remat else 0))
             + enc_f + enc_b)
    if not sh.whole_sub_blocks(cfg, {sh.MODEL_AXIS: m})["vocab"]:
        total += 3 * rows * seq * FP32_BYTES
    return total + FP32_BYTES * _partial_grad_elements(cfg, m, sh.residual_len(cfg, seq))


def _partial_grad_elements(cfg, m: int, res_len: int) -> int:
    """The elements of the gradients a tensor-parallel rank sums over a
    model axis of ``m`` (``tensor_parallel.grad_is_partial``), for a
    residual of ``res_len`` positions."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.tensor_parallel import grad_is_partial
    from repro_torch.models.transformer import init_params

    with FakeTensorMode():
        params = init_params(cfg, device="cpu")
    ctx = sh.make_ctx(cfg, comm=_AxisComm({sh.MODEL_AXIS: m}), seq=res_len)
    total = 0
    for (key, p), spec in zip(tree_lib.flatten_with_path(params),
                              tree_lib.leaves(sh.param_specs(params, cfg, {sh.MODEL_AXIS: m}))):
        split = any(sh.MODEL_AXIS in _names(e) for e in spec)
        if grad_is_partial(key, split, ctx):
            total += p.numel()
    return total


class _AxisComm:
    """What ``sharding.specs.make_ctx`` reads of a mesh's ``Collectives``
    (its axis sizes; rank 0), without a world."""

    def __init__(self, sizes: dict):
        self.axis_sizes = sizes

    def size(self, axes) -> int:
        return math.prod(self.axis_sizes.get(a, 1) for a in axes)

    def index(self, axes) -> int:
        return 0


def _layer_branches(cfg, whole: dict) -> list:
    """Whether each branch of a decoder layer runs whole on every rank, in
    order: the mixer (hymba's attention and SSM, closed by one reduce,
    whole only when both are), whisper's cross-attention, the MLP or MoE
    block."""
    arch = cfg.arch_type
    if arch == "ssm":
        return [whole["ssm"]]
    out = [whole["q"] and whole["ssm"]] if arch == "hybrid" else [whole["q"]]
    if arch == "audio":
        out.append(whole["q"])
    out.append(whole["experts"] if arch == "moe" else whole["mlp"])
    return out


def _tp_forward(cfg, rows: int, seq: int, m: int, elt: int) -> tuple:
    """The forward's ``'tp'`` collectives of the tensor-parallel model on
    ``rows`` x ``seq`` text tokens a rank and a model axis of ``m``, each
    with its backward, as :func:`tp_bytes` counts them: ``(edge, layer,
    encoder)``, each a (forward, backward) pair of bytes. ``edge``: the
    embedding and the logits' gather; ``layer``: one decoder layer's
    branches (a split one's sequence gather and reduce, a whole one's
    gather), its 'hd' column gathers (the cross-attention's too), a split
    SSM layer's gated-norm all-reduce and, with its heads whole, the gather
    of its convolved input; ``encoder``: whisper's encoder layers and the
    gather of their output (0 without an encoder)."""
    res_len = sh.residual_len(cfg, seq)
    seq_shard = sh.sequence_sharded(res_len, m)
    tokens = rows * res_len
    d, arch = cfg.d_model, cfg.arch_type
    audio = arch == "audio"
    whole = sh.whole_sub_blocks(cfg, {sh.MODEL_AXIS: m})

    def branch(is_whole: bool, n: int = tokens, sharded: bool = seq_shard,
               size: int = elt) -> tuple:
        """A branch's bytes each way: a split one's gather and reduce of
        (rows, n / rows, d), a whole one's gather."""
        act = n * d * size
        one_way = (act if sharded else 0) if is_whole else (act + act // m if sharded else act)
        return one_way, one_way

    def cols(width: int, n: int = tokens, size: int = elt) -> tuple:
        """A column gather of (rows, n / rows, width) and its reduce-scatter."""
        act = n * width * size
        return act, act // m

    def add(*terms) -> tuple:
        return tuple(map(sum, zip((0, 0), *terms)))

    layer = [branch(w) for w in _layer_branches(cfg, whole)]
    encoder = []
    if bool(cfg.num_heads) and arch != "ssm":
        ql, kvl = sh.attn_layouts(cfg, m)
        # The self-attention's columns; whisper's cross-attention's Q too.
        q = [cols(cfg.q_dim)] * (2 if audio else 1) if ql == "hd" else []
        kv = [cols(cfg.kv_dim)] * 2 if kvl == "hd" else []
        layer += q + kv
        if audio:
            enc = rows * cfg.encoder_seq
            enc_shard = sh.sequence_sharded(cfg.encoder_seq, m)
            enc_kv = [cols(cfg.kv_dim, enc, FP32_BYTES)] * 2 if kvl == "hd" else []
            enc_q = [cols(cfg.q_dim, enc, FP32_BYTES)] if ql == "hd" else []
            # The cross-attention's K/V, from the encoder output.
            layer += enc_kv
            enc_layer = add(branch(whole["q"], enc, enc_shard, FP32_BYTES),
                            branch(whole["mlp"], enc, enc_shard, FP32_BYTES), *enc_kv, *enc_q)
            # The output's gather: an all-gather forward when sharded; its
            # backward a reduce-scatter (an all-reduce unsharded) of the
            # partial cotangents, or nothing for whole heads' whole one.
            act = enc * d * FP32_BYTES
            out = (act if enc_shard else 0,
                   0 if whole["q"] else act // m if enc_shard else act)
            encoder = [tuple(cfg.encoder_layers * x for x in enc_layer), out]
    if arch in ("ssm", "hybrid") and not whole["ssm"]:
        layer.append((tokens * FP32_BYTES, tokens * FP32_BYTES))
        if not sh.ssm_heads_split(cfg, m):
            layer.append(cols(sh.ssm_dims(cfg).d_inner))
    return branch(whole["vocab"]), add(*layer), add(*encoder)


def _tp_serve_bytes(cfg, rows: int, seq: int, sizes: dict, *, mode: str,
                    batch: Optional[int] = None, cache_len: Optional[int] = None,
                    kv_seq_shard: bool = False, compute_bytes: int = 2) -> int:
    """The ``'tp'`` collective bytes of one rank for one prefill
    (``mode="prefill"``: ``rows`` x ``seq`` text tokens, the residual
    :func:`sharding.specs.residual_len` long) or one decode step
    (``mode="decode"``: ``rows`` tokens against a cache of ``seq``
    positions) on a mesh, from the shapes. ``rows`` are the rank's data
    coordinate's; the cache is laid out by ``sharding.specs.cache_specs``
    for ``batch`` rows over the mesh (``rows`` times the data axes' size
    unless given), ``cache_len`` positions (prefill: the residual's length
    unless given; decode: ``seq``) and ``kv_seq_shard``. Activations and
    the cache of ``compute_bytes`` (a prefill writes the cache in the
    activations' dtype); whisper's encoder and the cross-attention's K/V
    fp32, as :func:`tp_bytes` takes them. No backward and no recompute.
    A sub-block the model axis leaves whole moves nothing but its
    sequence-sharded input's gather. Counted:

    prefill -- the train forward's collectives once (:func:`_tp_forward`);
    and for the cache: with its sequence over ``model`` in the 'head' KV
    layout, each attention layer's K and V heads gathered over ``model``
    ((rows, S', Hkv, hd) each); with a split ``d_inner`` and the SSM heads
    whole, each layer's last K-1 raw inputs gathered ((rows, K-1,
    d_inner)). On a mesh without a model split: nothing (every rank
    computes its rows, or a batch of one whole, and keeps its positions).

    decode -- the embedding's all-reduce (a split vocab) and each split
    branch's reduce of (rows, 1, d) (the one-position residual is never
    sequence-sharded: the gathers are the identity); in each
    self-attention layer, split Q's columns gathered where the cache's
    sequence is over ``model`` or Q is 'hd', split K/V's where it is over
    ``model`` or KV is 'hd'; in the 'hd' KV layout (the sequence not over
    ``model``) the rank's cache, K and V, gathered over ``model`` on
    head_dim ((rows, T_local, Hkv, hd)); with the sequence split (over
    ``model``, or over the data axes), the merge of the softmax: a (rows,
    heads) fp32 max and a (rows, heads, hd + 1) fp32 sum, ``heads`` the Q
    heads the rank attends (every head over ``model``, in Q 'hd' or with Q
    whole, else its own); whisper's cross-attention: Q's columns in 'hd',
    K/V's of the whole encoder output in 'hd'; a split SSM layer's
    gated-norm (rows, 1) fp32 all-reduce, and with its heads whole its raw
    and convolved (rows, d_inner) inputs gathered. On a mesh without a
    model split, only the merge over the data axes.
    """
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode', got {mode!r}")
    m = sizes.get(sh.MODEL_AXIS, 1)
    d, arch, elt = cfg.d_model, cfg.arch_type, compute_bytes
    data = math.prod(v for a, v in sizes.items() if a != sh.MODEL_AXIS)
    batch = rows * data if batch is None else batch
    prefill = mode == "prefill"
    res_len = sh.residual_len(cfg, seq) if prefill else 1
    length = seq if not prefill else (res_len if cache_len is None else cache_len)
    specs = sh.cache_specs(cfg, sh.decode_shape(batch, length), sizes,
                           kv_seq_shard=kv_seq_shard, cache_len=length)
    tokens = rows * res_len
    attn = bool(cfg.num_heads) and arch != "ssm"
    whole = sh.whole_sub_blocks(cfg, {sh.MODEL_AXIS: m})
    ssm_split = arch in ("ssm", "hybrid") and m > 1 and not whole["ssm"]
    heads_whole = ssm_split and not sh.ssm_heads_split(cfg, m)
    d_inner = sh.ssm_dims(cfg).d_inner if arch in ("ssm", "hybrid") else 0
    if attn:
        ql, kvl = sh.attn_layouts(cfg, m)
        seq_axes = tuple(a for a in sh.spec_entry_names(specs["kv"][0][2])
                         if sizes.get(a, 1) > 1)
        over_model = sh.MODEL_AXIS in seq_axes
        kv_cols = 2 * tokens * cfg.kv_dim * elt
    if prefill:
        if m <= 1:
            return 0
        (edge, _), (layer, _), (encoder, _) = _tp_forward(cfg, rows, seq, m, elt)
        cache = 0
        if attn and over_model and kvl == "head":
            cache += kv_cols
        if heads_whole:
            cache += rows * (sh.ssm_dims(cfg).conv_kernel - 1) * d_inner * elt
        return edge + cfg.num_layers * (layer + cache) + encoder
    # One position: a reduce of (rows, 1, d) for each split branch and the
    # embedding; no gather.
    act = tokens * d * elt if m > 1 else 0
    per_layer = act * sum(not w for w in _layer_branches(cfg, whole))
    if attn:
        per_layer += tokens * cfg.q_dim * elt if (over_model and ql == "head") or ql == "hd" else 0
        per_layer += kv_cols if (over_model and kvl == "head") or kvl == "hd" else 0
        if kvl == "hd" and not over_model:
            local_len = length // sh.spec_entry_size(specs["kv"][0][2], sizes)
            per_layer += 2 * rows * local_len * cfg.kv_dim * elt
        if seq_axes:
            heads = (cfg.num_heads if over_model or ql != "head" or m <= 1
                     else cfg.num_heads // m)
            per_layer += FP32_BYTES * rows * heads * (cfg.head_dim + 2)
    if ssm_split:
        per_layer += tokens * FP32_BYTES
        if heads_whole:
            per_layer += 2 * tokens * d_inner * elt
    total = (0 if whole["vocab"] else act) + cfg.num_layers * per_layer
    if arch == "audio":
        # The cross-attention: Q's columns and the encoder output's K/V in 'hd'.
        enc_kv = 2 * rows * cfg.encoder_seq * cfg.kv_dim * FP32_BYTES if kvl == "hd" else 0
        total += cfg.num_layers * ((tokens * cfg.q_dim * elt if ql == "hd" else 0) + enc_kv)
    return total


# ---------------------------------------------------------------------------
# Schedule + bucket-comm pricing (used by core/program.py's compiler)
# ---------------------------------------------------------------------------


def ns_chain_flops(packed_shape, ns_steps: int) -> int:
    """Modeled FLOPs of one batched K-step Newton-Schulz chain.

    Per iteration on an (m, n) matrix with s = min(m, n) (the kernels
    transpose to iterate on the small side): the Gram matrix ``A = X X^T``
    is 2 s^2 n, ``A^2`` is 2 s^3, and the update ``aX + P X`` is 2 s^2 n —
    so ~``4 s^2 n + 2 s^3`` FLOPs per unit per iteration, times the stack
    size and the chain length.
    """
    if len(packed_shape) < 2:
        return 0
    m, n = int(packed_shape[-2]), int(packed_shape[-1])
    s, n = min(m, n), max(m, n)
    stack = 1
    for d in packed_shape[:-2]:
        stack *= int(d)
    return int(stack * ns_steps * (4 * s * s * n + 2 * s ** 3))


def overlappable_ns_bytes(packed_shape, ns_steps: int, link: str = "ici") -> int:
    """Collective bytes one bucket's NS chain can hide, in the modeled ratio.

    ``time_ns = flops / MODELED_NS_FLOPS_PER_S`` of compute runs while a
    pipelined gather is in flight; at the link's modeled bandwidth
    (:data:`MODELED_LINK_BYTES_PER_S` — ICI for intra-pod axes, the slower
    DCN for inter-pod) that hides ``time_ns * rate`` bytes. The program's
    :class:`PipelineStage` exposed bytes are
    ``max(0, gather_bytes - overlappable_ns_bytes(compute op))`` per link
    class: the same NS chain hides 8x fewer DCN bytes than ICI bytes,
    which is why the schedule issues the largest *inter-pod* gather first.
    """
    if link not in MODELED_LINK_BYTES_PER_S:
        raise ValueError(f"link must be one of {LINKS}, got {link!r}")
    flops = ns_chain_flops(packed_shape, ns_steps)
    return int(flops / MODELED_NS_FLOPS_PER_S * MODELED_LINK_BYTES_PER_S[link])


def layer_shard_dims(packed_shape, axis_size: int) -> tuple[int, int, int, int]:
    """``(stack, stack_padded, m, n)`` of a layer-sharded packed stack: the
    flatten + ceil-pad arithmetic of :func:`layer_shard_collectives`, which
    the program's layer_shard op and the engine's fold share.
    """
    m, n = int(packed_shape[-2]), int(packed_shape[-1])
    stack = 1
    for d in packed_shape[:-2]:
        stack *= int(d)
    axis_size = max(int(axis_size), 1)
    stack_p = -(-stack // axis_size) * axis_size
    return stack, stack_p, m, n


def layer_shard_collectives(
    packed_shape, axis: str, axis_size: int, *, mode: str
) -> tuple:
    """Price the layer_shard split of a packed (..., m, n) full-step stack.

    Returns ``(op, axes, per_rank_result_bytes)`` tuples in the program's
    CommOp convention, as the reference prices its two execution modes:

      * ``mode='engine'`` -- an explicit fold: each rank slices its share of
        layers locally, orthogonalizes it, and one all-gather over ``axis``
        restores the full padded stack: exactly one collective.
      * ``mode='gspmd'`` -- the reference's model of what its compiler's
        partitioner emits for the re-shard: one all-gather of the padded
        stack on each side of the constraint, plus, when the stack pads,
        one all-reduce carrying the padded and unpadded stacks.
    """
    if len(packed_shape) < 3 or axis_size <= 1:
        return ()
    stack, stack_p, m, n = layer_shard_dims(packed_shape, axis_size)
    full = stack_p * m * n * FP32_BYTES
    if mode == "engine":
        return (("all-gather", (axis,), full),)
    if mode == "gspmd":
        out = [("all-gather", (axis,), full), ("all-gather", (axis,), full)]
        if stack_p > stack:
            out.append(
                ("all-reduce", (axis,), (stack_p + stack) * m * n * FP32_BYTES)
            )
        return tuple(out)
    raise ValueError(f"mode must be 'engine' or 'gspmd', got {mode!r}")
