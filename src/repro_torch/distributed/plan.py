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


def tp_bytes(cfg, rows: int, seq: int, axis_sizes, *, compute_bytes: int = 2) -> int:
    """The ``'tp'`` collective bytes of one rank and training step of the
    tensor-parallel dense or MoE model (``distributed/tensor_parallel.py``),
    from the shapes; 0 where ``sharding.specs.mesh_path`` runs ``cfg``
    replicated.

    ``rows`` x ``seq`` tokens a rank (its data coordinate's rows),
    activations of ``compute_bytes`` an element, the replicated leaves'
    gradients fp32; result-buffer bytes, as the plan's (a reduce-scatter's
    is the rank's slice). Counted: each layer's two sequence gathers
    (attention and MLP or MoE in) and two reduces (their row-parallel
    ``wo`` out, the MoE block's partial output after the combine), forward
    and backward, and on the 'hd' KV layout the K and V column gathers; the
    embedding's reduce and the logits' gather; the cross entropy's three
    (B, S) fp32 all-reduces; the sum over the model axis of the gradients
    ``tensor_parallel.grad_is_partial`` names: with a sequence-sharded
    residual every replicated leaf's (the norm gains, an MoE model's
    router), else the router's alone.
    """
    sizes = sh.mesh_axis_sizes(axis_sizes)
    if sh.mesh_path(cfg, sizes) != sh.TENSOR_PARALLEL:
        return 0
    m = sizes[sh.MODEL_AXIS]
    seq_shard = sh.sequence_sharded(seq, m)
    act = rows * seq * cfg.d_model * compute_bytes
    # A sequence gather (or reduce) and its backward: all-gather and
    # reduce-scatter when the residual is sequence-sharded, else one
    # all-reduce (backward of the gather, forward of the reduce).
    pair = act + act // m if seq_shard else act
    per_layer = 4 * pair
    if sh.attn_layouts(cfg, m)[1] == "hd":
        kv = rows * seq * cfg.kv_dim * compute_bytes
        per_layer += 2 * (kv + kv // m)
    total = cfg.num_layers * per_layer + 2 * pair + 3 * rows * seq * FP32_BYTES
    if seq_shard:
        norms = 2 + (2 if cfg.use_post_norms else 0)
        total += FP32_BYTES * (cfg.num_layers * norms * cfg.d_model + cfg.d_model)
    if cfg.num_experts:
        total += FP32_BYTES * cfg.num_layers * cfg.d_model * cfg.num_experts
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
    flatten + ceil-pad arithmetic of :func:`layer_shard_collectives`.

    The layer_shard schedule itself (each rank orthogonalizing a share of
    the layers) is not executed by the port yet; its pricing is the
    reference's, carried by :class:`CommPlan`.
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
