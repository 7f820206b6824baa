"""Partition specs and MuonBP block grids of every arch, without a mesh.

Counterpart of ``repro/sharding/specs.py``. The reference reads only the
mesh's axis names and sizes; every rule here reads an ``{axis: size}``
dict, or a live ``torch.distributed`` ``DeviceMesh`` through
:func:`mesh_axis_sizes`. ``{"model": 8}`` gives the paper's 8-way
tensor-parallel block grids on one GPU (the reference's ``--mesh-model 8``);
a ``('pod', 'data', 'model')`` mesh of ranks gives the distributed layout
(``distributed/``): the ZeRO-1 momentum specs, the flatten fallback, the
batch and cache specs.

A partition spec is a tuple with one entry per dim: ``None``, an axis
name, or a tuple of axis names (major to minor). Megatron-style rules over
the ``model`` axis:

* embeddings vocab-parallel; lm_head column(vocab)-parallel;
* attention (and whisper's cross-attention and encoder attention):
  column-parallel wq/wk/wv, row-parallel wo; when the head count does not
  divide the axis the projection shards on head_dim ('hd' layout), and
  when neither divides it is replicated;
* MLP: column-parallel wi/wg, row-parallel wo;
* MoE: the experts' wi/wg column-parallel and wo row-parallel on their
  trailing two dims (the ``(L, E)`` lead dims whole, so each expert's d_ff
  splits), the router replicated;
* SSM: wz/wx and conv_x / conv_x_bias on d_inner, wdt and the per-head
  A_log / D / dt_bias on heads (each where the axis divides them), wb/wc
  and the B/C convs replicated, out_proj row-parallel on d_inner. Where
  d_inner divides the axis and the head count does not (hymba's 50 heads
  on model 4, 8 or 16), d_inner splits off the head boundaries and wdt
  and the per-head scalars stay whole (:func:`ssm_heads_split`); their
  MuonBP block grids (:func:`block_specs_for`), momentum specs and
  flatten fallback follow from these specs, whole, as the reference's do;
* norms (gate_norm too: the name rule comes first, as in the reference),
  hymba's attn_scale / ssm_scale and everything else replicated.

A weight the axis does not divide stays whole on every rank (the
reference's ``col``/``row`` fall back to replicated), and
:func:`whole_sub_blocks` names the sub-blocks that are whole so: the model
computes each of them whole on every rank (:class:`ShardCtx`). Its MuonBP
block grid is 1x1: its block step orthogonalizes it whole, with no
collective, and its full step gathers nothing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Union

from repro_torch import tree as tree_lib
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.blocking import block_spec_from_partition
from repro_torch.models.layers import FLASH_BLOCK_K
from repro_torch.models.transformer import ssm_dims

MODEL_AXIS = "model"
DATA_AXES = ("pod", "data")


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """``{axis: size}`` of a mesh: a dict passes through (copied), a
    ``DeviceMesh`` gives its dim names and sizes in order."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def data_axes_for(mesh) -> tuple[str, ...]:
    sizes = mesh_axis_sizes(mesh)
    return tuple(a for a in DATA_AXES if a in sizes)


def path_names(path) -> list[str]:
    """Path components as strings (the port's paths are already tuples of str)."""
    return [str(k) for k in path]


def path_str(path) -> str:
    """Canonical 'a/b/c' key of a tree path."""
    return "/".join(path_names(path))


def spec_entry_names(entry) -> tuple:
    """Axis names of one spec entry (None -> ())."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_entry_size(entry, sizes: dict[str, int]) -> int:
    """Total shard factor of one spec entry on a mesh."""
    size = 1
    for name in spec_entry_names(entry):
        size *= sizes.get(name, 1)
    return size


def spec_entries(spec, ndim: int) -> list:
    """The spec's entries padded with None to ``ndim``."""
    entries = list(spec) if spec is not None else []
    return entries + [None] * (ndim - len(entries))


def local_shape(spec, shape, sizes: dict[str, int]) -> tuple:
    """Per-rank shard shape of a tensor with partition spec ``spec``: the
    global -> local rule shared by the plan, the engine and the program."""
    return tuple(d // spec_entry_size(e, sizes)
                 for d, e in zip(shape, spec_entries(spec, len(shape))))


def _divides(n: int, m: int) -> bool:
    return m > 0 and n % m == 0


def attn_layouts(cfg: ModelConfig, model_size: int) -> tuple[Optional[str], Optional[str]]:
    """(q_layout, kv_layout): 'head' | 'hd' | None (replicate)."""

    def layout(heads: int) -> Optional[str]:
        if model_size <= 1:
            return "head"
        if _divides(heads, model_size):
            return "head"
        if _divides(cfg.head_dim, model_size):
            return "hd"
        return None

    return layout(cfg.num_heads), layout(cfg.num_kv_heads)


TENSOR_PARALLEL, REPLICATED = "tensor_parallel", "replicated"


def mesh_path(cfg: ModelConfig, axis_sizes) -> str:
    """How a mesh of ranks runs ``cfg``: ``"tensor_parallel"`` (each rank
    holds and computes with its ``param_specs`` shards) or ``"replicated"``
    (no model split: each rank holds the whole model, and its updates come
    out whole).

    Every config on a ``model`` axis larger than one is tensor-parallel, and
    a mesh without a model split is replicated. Where the axis divides a
    weight, the rank holds and computes its shard; where it does not, the
    weight is whole on every rank, as the reference keeps it
    (``repro/sharding/specs.py``'s ``col``/``row`` rules, its MoE
    ``use_model``): Q and K/V projections with no 'head' or 'hd' layout,
    ``d_ff``, an MoE model's expert ``d_ff``, an SSM's ``d_inner`` and the
    padded vocab. :func:`whole_sub_blocks` names them, and the model runs
    each such sub-block whole on every rank (``models/transformer.py``).
    SSM heads that do not divide the axis while ``d_inner`` does run with
    the heads whole on every rank (:func:`ssm_heads_split`).
    """
    m = mesh_axis_sizes(axis_sizes).get(MODEL_AXIS, 1)
    return TENSOR_PARALLEL if m > 1 else REPLICATED


class _Shape:
    """A leaf that only has a shape: what :func:`param_specs` reads."""

    def __init__(self, *shape: int):
        self.shape = shape


def whole_sub_blocks(cfg: ModelConfig, axis_sizes) -> dict[str, bool]:
    """Which of ``cfg``'s sub-blocks keep their weights whole on every rank
    of the mesh's model axis, read from :func:`param_specs` (so that the
    model's context and the parameters never disagree): ``"q"`` and
    ``"kv"`` (the attention's Q and K/V projections: no 'head' or 'hd'
    layout), ``"mlp"`` (``d_ff``), ``"experts"`` (an MoE model's expert
    ``d_ff``), ``"ssm"`` (``d_inner``) and ``"vocab"`` (the embedding and
    the head). A sub-block the arch does not have is False; so is every
    one without a model split (the one-device path)."""
    m = mesh_axis_sizes(axis_sizes).get(MODEL_AXIS, 1)
    out = dict.fromkeys(("q", "kv", "mlp", "experts", "ssm", "vocab"), False)
    if m <= 1:
        return out
    d, arch = cfg.d_model, cfg.arch_type
    layers: dict = {}
    if cfg.num_heads and arch != "ssm":
        layers["attn"] = {"wq": _Shape(1, d, cfg.q_dim), "wk": _Shape(1, d, cfg.kv_dim)}
    if arch in ("dense", "vlm", "audio", "hybrid"):
        layers["mlp"] = {"wi": _Shape(1, d, cfg.d_ff)}
    if arch == "moe":
        layers["moe"] = {"wi": _Shape(1, cfg.num_experts, d, cfg.d_ff)}
    if arch in ("ssm", "hybrid"):
        layers["ssm"] = {"wx": _Shape(1, d, ssm_dims(cfg).d_inner)}
    specs = param_specs({"embed": _Shape(cfg.padded_vocab, d), "layers": layers}, cfg,
                        {MODEL_AXIS: m})
    whole = lambda spec: MODEL_AXIS not in spec
    groups = specs["layers"]
    if "attn" in groups:
        out["q"], out["kv"] = whole(groups["attn"]["wq"]), whole(groups["attn"]["wk"])
    for name, group in (("mlp", "mlp"), ("experts", "moe"), ("ssm", "ssm")):
        if group in groups:
            out[name] = whole(groups[group]["wi" if group != "ssm" else "wx"])
    out["vocab"] = whole(specs["embed"])
    return out


def ssm_heads_split(cfg: ModelConfig, model_size: int) -> bool:
    """Whether the SSM heads split over a model axis of ``model_size``: the
    head count divides it. Otherwise ``wdt``, ``A_log``, ``D`` and
    ``dt_bias`` stay whole on every rank while ``d_inner`` splits
    (:func:`param_specs`); ``models/ssm.py``, finding every head in a
    rank's shards, then runs every head on every rank."""
    return _divides(ssm_dims(cfg).num_heads, model_size)


def sequence_sharded(seq: int, model_size: int) -> bool:
    """Whether the residual between layers is split over the model axis on
    its sequence dim: the reference's ``_seq_shard`` (``S % model == 0`` and
    ``S > 1``)."""
    return model_size > 1 and seq > 1 and seq % model_size == 0


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Distribution context threaded through the model code (counterpart of
    the reference's ``transformer.ShardCtx``).

    The default is one device. ``comm`` (``distributed.audit.Collectives``)
    holds the mesh's groups; ``model_axes`` names the axis the weights split
    over and ``index`` this rank's place on it, so a rank's heads, columns,
    vocab rows and sequence shard are the ``index``-th of ``size``;
    ``seq_shard`` says whether the residual is sequence-sharded, and
    ``encoder_seq_shard`` whether whisper's encoder residual is (its own
    length, so its own rule). The layouts give the head order of the Q and
    K/V projections' columns (``layers.split_heads``), on one device too.
    ``flash_block_k`` is the KV block of the attention's online softmax
    (``layers.attention``), the reference's field and default.

    The decode cache's layout, for prefill and decode (``make_ctx(...,
    cache_len=)``; ``cache_len`` None: none): the buffer's ``cache_len``
    positions (the window of a ``ring_cache``), ``cache_batch`` rows in
    all, ``kv_seq_shard`` as :func:`cache_specs` takes it, and
    ``kv_seq_axes``, the axes its sequence dim splits over there: the
    model axis (``kv_seq_shard``), the data axes (rows that no data axis
    divides, a batch of one) or none; ``cache_shapes``, the rank's
    :func:`local_cache_shapes` of that layout, which
    ``transformer.init_cache`` allocates and a prefill and a decode step
    hold their cache to. On a mesh without a model split (``size`` 1) the
    context carries only the decode layout: each rank runs the one-device
    model on its rows, and with the cache's sequence over the data axes (a
    batch of one) every rank computes the same values and attends over its
    positions, the softmax merged over those axes.

    The sub-blocks whose weights are whole on every rank of the model axis
    (:func:`whole_sub_blocks`): Q and K/V where ``q_layout`` /
    ``kv_layout`` is None, ``mlp_whole``, ``experts_whole``, ``ssm_whole``
    (``d_inner``) and ``vocab_whole``. Every rank computes such a sub-block
    whole, on the whole sequence of its rows, and keeps its own sequence
    shard of the output (``tensor_parallel.enter_whole`` /
    ``leave_whole``); ``whole_on_index0`` names hymba's whole branch
    (``"attn"`` or ``"ssm"``) beside a split one, which enters the partial
    sum of the one reduce that closes both on model index 0 alone.
    """

    comm: Any = None
    model_axes: tuple = ()
    size: int = 1
    index: int = 0
    q_layout: Optional[str] = "head"
    kv_layout: Optional[str] = "head"
    mlp_whole: bool = False
    experts_whole: bool = False
    ssm_whole: bool = False
    vocab_whole: bool = False
    whole_on_index0: frozenset = frozenset()
    seq_shard: bool = False
    encoder_seq_shard: bool = False
    flash_block_k: int = FLASH_BLOCK_K
    cache_len: Optional[int] = None
    cache_batch: int = 0
    kv_seq_shard: bool = False
    ring_cache: bool = False
    kv_seq_axes: tuple = ()
    cache_shapes: Optional[dict] = dataclasses.field(default=None, compare=False)

    @property
    def tensor_parallel(self) -> bool:
        return self.size > 1

    @property
    def attn_whole(self) -> bool:
        """The attention's Q (and so its K/V) whole on every rank: every rank
        computes every head with the whole ``wo``."""
        return self.tensor_parallel and self.q_layout is None

    @property
    def mesh_cache(self) -> bool:
        """A decode layout on a mesh (``make_ctx(..., comm=, cache_len=)``):
        the cache a prefill makes and a decode step takes is the rank's
        :func:`cache_specs` shard."""
        return self.comm is not None and self.cache_len is not None

    def runs_whole(self, key) -> bool:
        """Whether the leaf at ``key`` belongs to a sub-block that every rank
        of the model axis computes whole and alike (``tensor_parallel.
        enter_whole`` / ``leave_whole``): its gradient is whole on every
        rank. Hymba's branch scales are, where both branches are whole."""
        if not self.tensor_parallel:
            return False
        group = key[-2] if len(key) > 1 else ""
        if len(key) == 1 and key[0] in ("embed", "lm_head"):
            return self.vocab_whole
        if group in ("attn", "cross"):
            return self.q_layout is None
        return {"mlp": self.mlp_whole, "moe": self.experts_whole, "ssm": self.ssm_whole,
                "hybrid": self.q_layout is None and self.ssm_whole}.get(group, False)

    @property
    def cache_seq_over_model(self) -> bool:
        """The cache's sequence dim splits over the model axis
        (``kv_seq_shard`` taken): every head on every rank."""
        return MODEL_AXIS in self.kv_seq_axes

    def kv_seq_range(self) -> tuple[int, int]:
        """The rank's first and past-the-last position of the cache's
        ``cache_len``."""
        if not self.kv_seq_axes:
            return 0, self.cache_len
        n = self.cache_len // self.comm.size(self.kv_seq_axes)
        start = self.comm.index(self.kv_seq_axes) * n
        return start, start + n


def make_ctx(cfg: ModelConfig, engine=None, seq: Optional[int] = None, *, comm=None,
             batch: Optional[int] = None, cache_len: Optional[int] = None,
             kv_seq_shard: bool = False, ring_cache: bool = False) -> ShardCtx:
    """The model's context on the mesh of ``engine``
    (``distributed.engine.ShardMapEngine``), or of ``comm``
    (``distributed.audit.Collectives``: prefill and decode hold no engine),
    for a residual of ``seq`` positions, the whole length (a VLM's
    ``vision_tokens`` plus its text; :func:`residual_len`): tensor-parallel
    on a model axis larger than one (the engine's ``tensor_parallel``), its
    whole sub-blocks from :func:`whole_sub_blocks`, else the one-device
    context (the replicated path). Without either, one device. whisper's
    encoder residual is ``cfg.encoder_seq`` frames long.

    ``cache_len`` makes the context of a prefill of ``seq`` positions and
    of the decode steps after it: a cache of ``cache_len`` positions (the
    ring's window with ``ring_cache``) for ``batch`` rows over the mesh,
    laid out by :func:`cache_specs` (``kv_seq_shard`` as it takes it), on
    a model split or without one: there, as the reference's layout, the
    rows over the data axes where they divide, else the cache's sequence
    over the data axes (a batch of one).
    """
    if engine is not None:
        comm, tp = engine.comm, engine.tensor_parallel
    else:
        tp = comm is not None and comm.size((MODEL_AXIS,)) > 1
    if cache_len is not None and (batch is None or seq is None):
        raise ValueError("a decode layout needs the global rows and the prefill's length")
    if not tp:
        ctx = ShardCtx()
        if cache_len is None:
            return ctx
        if comm is None:
            return dataclasses.replace(ctx, cache_len=cache_len, ring_cache=ring_cache)
    else:
        if seq is None:
            raise ValueError("a tensor-parallel context needs the sequence length")
        axes = (MODEL_AXIS,)
        m = comm.size(axes)
        ql, kvl = attn_layouts(cfg, m)
        whole = whole_sub_blocks(cfg, {MODEL_AXIS: m})
        index0 = frozenset()
        if cfg.arch_type == "hybrid" and whole["q"] != whole["ssm"]:
            index0 = frozenset({"attn" if whole["q"] else "ssm"})
        ctx = ShardCtx(comm=comm, model_axes=axes, size=m, index=comm.index(axes),
                       q_layout=ql, kv_layout=kvl, mlp_whole=whole["mlp"],
                       experts_whole=whole["experts"], ssm_whole=whole["ssm"],
                       vocab_whole=whole["vocab"], whole_on_index0=index0,
                       seq_shard=sequence_sharded(seq, m),
                       encoder_seq_shard=sequence_sharded(cfg.encoder_seq, m))
        if cache_len is None:
            return ctx
    sizes = comm.axis_sizes
    specs = cache_specs(cfg, decode_shape(batch, cache_len), sizes, kv_seq_shard=kv_seq_shard,
                        cache_len=cache_len)
    seq_axes = spec_entry_names(specs["kv"][0][2]) if "kv" in specs else ()
    return dataclasses.replace(
        ctx, comm=comm, cache_len=cache_len, cache_batch=batch, kv_seq_shard=kv_seq_shard,
        ring_cache=ring_cache,
        # An axis of one splits nothing (the model axis of a mesh without a model split).
        kv_seq_axes=tuple(a for a in seq_axes if sizes.get(a, 1) > 1),
        cache_shapes=local_cache_shapes(cfg, batch, cache_len, sizes,
                                        kv_seq_shard=kv_seq_shard))


def residual_len(cfg: ModelConfig, seq: int) -> int:
    """The residual's length for ``seq`` text tokens: a VLM's vision tokens
    come first."""
    return seq + cfg.vision_tokens


def param_specs(params, cfg: ModelConfig, axis_sizes) -> dict:
    """Tree of partition-spec tuples matching ``params`` (``axis_sizes``: a
    dict or a ``DeviceMesh``)."""
    m = mesh_axis_sizes(axis_sizes).get(MODEL_AXIS, 1)
    ql, kvl = attn_layouts(cfg, m)
    dims = ssm_dims(cfg) if cfg.arch_type in ("ssm", "hybrid") else None
    heads_ok = dims is not None and ssm_heads_split(cfg, m)
    inner_ok = dims is not None and _divides(dims.d_inner, m)

    def rep(leaf):
        return (None,) * len(leaf.shape)

    def col(leaf, ok=True):
        if not ok or not _divides(leaf.shape[-1], m):
            return rep(leaf)
        return (None,) * (len(leaf.shape) - 1) + (MODEL_AXIS,)

    def row(leaf, ok=True):
        if not ok or not _divides(leaf.shape[-2], m):
            return rep(leaf)
        return (None,) * (len(leaf.shape) - 2) + (MODEL_AXIS, None)

    def spec(path, leaf):
        name = path[-1]
        group = path[-2] if len(path) >= 2 else ""
        if name == "embed":
            return (MODEL_AXIS, None) if _divides(leaf.shape[0], m) else rep(leaf)
        if name == "lm_head":
            return col(leaf)
        if "norm" in name or name in ("attn_scale", "ssm_scale"):
            return rep(leaf)
        if group in ("attn", "cross"):
            if name == "wq":
                return col(leaf, ql is not None)
            if name in ("wk", "wv"):
                return col(leaf, kvl is not None)
            if name == "wo":
                return row(leaf, ql is not None)
        if group in ("mlp", "moe"):
            if name in ("wi", "wg"):
                return col(leaf)
            if name == "wo":
                return row(leaf)
        if group == "ssm":
            # gate_norm never gets here: the "norm" rule replicates it first, as in the reference.
            # Weights shard on d_inner whenever it divides, even where the
            # head count does not (hymba's 50 heads): wdt and the per-head
            # scalars stay whole then (ssm_heads_split), as in the reference.
            if name in ("wz", "wx", "conv_x", "conv_x_bias"):
                return col(leaf, inner_ok)
            if name in ("wdt", "A_log", "D", "dt_bias"):
                return col(leaf, heads_ok)
            if name == "out_proj":
                return row(leaf, inner_ok)
        return rep(leaf)

    return tree_lib.map_with_path(spec, params)


def block_specs_for(params, specs, axis_sizes) -> dict:
    """MuonBP block grid per param: blocks = model-parallel shards."""
    sizes = mesh_axis_sizes(axis_sizes)
    return tree_lib.tree_map(
        lambda p, s: block_spec_from_partition(s, tuple(p.shape), sizes), params, specs
    )


ZeroAxes = Union[str, tuple]


def zero1_axes(mesh_axis_sizes: dict[str, int],
               axis: Optional[ZeroAxes] = None) -> tuple[str, ...]:
    """The ZeRO-1 axes: ``None`` resolves to the mesh's data axes, major to
    minor (``('pod', 'data')`` on a multi-pod mesh); a name or a tuple
    passes through as a tuple."""
    if axis is None:
        return tuple(a for a in DATA_AXES if a in mesh_axis_sizes)
    if isinstance(axis, str):
        return (axis,)
    return tuple(axis)


def _zero1_entry(axes: tuple[str, ...]):
    """Spec entry of the ZeRO-1 lead dim (a name for one axis)."""
    return _axes_entry(axes)


def momentum_spec(spec, shape, mesh_axis_sizes: dict[str, int], *, zero1: bool = False,
                  zero1_axis: Optional[ZeroAxes] = "data", label: str = "muon") -> tuple:
    """Optimizer-state spec of a param with spec ``spec``.

    The param's layout; with ``zero1`` the unsharded *lead* dim is also
    split over the ZeRO axes where their extent divides it. A muon leaf
    qualifies only with a stack dim (ndim >= 3): its trailing two dims are
    the MuonBP blocks. Any other label (AdamW's coordinate-wise state)
    qualifies from ndim 2, so the embedding and head state shard too. When
    the full extent does not divide the lead dim, major axes are dropped
    one at a time until a dividing suffix remains; only when none divides
    is the rule a no-op (:func:`zero1_flatten_info` plans the fallback).
    """
    entries = spec_entries(spec, len(shape))
    min_ndim = 3 if label == "muon" else 2
    if zero1 and len(shape) >= min_ndim and entries[0] is None:
        axes = zero1_axes(mesh_axis_sizes, zero1_axis)
        while axes:
            d = math.prod(mesh_axis_sizes.get(a, 1) for a in axes)
            if d > 1 and shape[0] % d == 0:
                entries[0] = _zero1_entry(axes)
                break
            axes = axes[1:]
    return tuple(entries)


@dataclasses.dataclass(frozen=True)
class FlattenSpec:
    """ZeRO-1 flatten-and-shard fallback of one leaf.

    When the lead dim does not divide the ZeRO extent (granite's 36 layers
    on 16 data ranks), the momentum is stored with its lead dim ceil-padded
    to a multiple of the extent and split over ``axes``: each rank holds
    whole layers, so block steps stay local. Pad layers are zero and stay
    zero (``mu*0 + 0``; a zero matrix orthogonalizes to zero).
    """

    axes: tuple[str, ...]   # ZeRO axes, major to minor
    factor: int             # product of the axes' sizes
    lead: int               # original lead dim
    padded_lead: int        # ceil(lead / factor) * factor

    @property
    def pad(self) -> int:
        return self.padded_lead - self.lead

    def padded_shape(self, shape) -> tuple:
        return (self.padded_lead, *tuple(shape)[1:])


def zero1_flatten_info(spec, shape, mesh_axis_sizes: dict[str, int], *,
                       zero1_axis: Optional[ZeroAxes] = "data",
                       label: str = "muon") -> Optional[FlattenSpec]:
    """The flatten fallback of a leaf, iff the full ZeRO extent does not
    divide its lead dim: None for non-muon leaves, leaves under 3 dims, a
    lead dim already sharded, trivial ZeRO axes or a dividing extent.
    Callers that enable the fallback check it before :func:`momentum_spec`.
    """
    shape = tuple(shape)
    if label != "muon" or len(shape) < 3:
        return None
    if spec_entries(spec, len(shape))[0] is not None:
        return None
    axes = zero1_axes(mesh_axis_sizes, zero1_axis)
    d = math.prod(mesh_axis_sizes.get(a, 1) for a in axes)
    if d <= 1 or shape[0] % d == 0:
        return None
    padded = -(-shape[0] // d) * d
    return FlattenSpec(axes=axes, factor=d, lead=shape[0], padded_lead=padded)


def flatten_momentum_spec(spec, shape, info: FlattenSpec) -> tuple:
    """Momentum spec of a flatten-fallback leaf (of its padded shape)."""
    entries = spec_entries(spec, len(tuple(shape)))
    entries[0] = _zero1_entry(info.axes)
    return tuple(entries)


# ---------------------------------------------------------------------------
# Input / cache specs
# ---------------------------------------------------------------------------

def _axes_entry(axes: tuple):
    """A spec entry of several axes: None, the name of one, or the tuple
    (a one-axis tuple normalizes to its name, as the reference's specs do)."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def batch_axes_for(global_batch: int, mesh) -> tuple[str, ...]:
    """Largest prefix of the data axes that divides the batch."""
    sizes = mesh_axis_sizes(mesh)
    axes: list[str] = []
    prod = 1
    for a in data_axes_for(sizes):
        if global_batch % (prod * sizes[a]) == 0:
            axes.append(a)
            prod *= sizes[a]
    return tuple(axes)


def input_batch_specs(cfg: ModelConfig, shape: InputShape, mesh) -> dict:
    """Specs of the input batch dict: the batch dim over the data axes."""
    b = _axes_entry(batch_axes_for(shape.global_batch, mesh))
    specs = {"tokens": (b, None)}
    if shape.kind == "train":
        specs["labels"] = (b, None)
    if cfg.arch_type == "vlm":
        specs["vision_embeds"] = (b, None, None)
    if cfg.arch_type == "audio":
        specs["audio_frames"] = (b, None, None)
    return specs


def cache_specs(cfg: ModelConfig, shape: InputShape, mesh, kv_seq_shard: bool = False,
                cache_len: Optional[int] = None) -> dict:
    """Specs of the decode cache of ``transformer.init_cache``.

    ``kv_seq_shard`` shards the cache's sequence dim over the model axis in
    place of heads / head_dim; a batch of one shards it over the data axes.
    """
    sizes = mesh_axis_sizes(mesh)
    m = sizes.get(MODEL_AXIS, 1)
    baxes = batch_axes_for(shape.global_batch, sizes)
    b = _axes_entry(baxes)
    eff_len = cache_len or shape.seq_len
    seq_axes = None
    if not baxes:
        data = data_axes_for(sizes)
        prod = math.prod(sizes[a] for a in data) if data else 1
        if data and eff_len % prod == 0:
            seq_axes = _axes_entry(data)

    specs: dict = {}
    if cfg.num_heads and cfg.arch_type != "ssm":
        _, kvl = attn_layouts(cfg, m)
        if kv_seq_shard and seq_axes is None and eff_len % m == 0:
            kv = (None, b, MODEL_AXIS, None, None)
        elif kvl == "head":
            kv = (None, b, seq_axes, MODEL_AXIS, None)
        elif kvl == "hd":
            kv = (None, b, seq_axes, None, MODEL_AXIS)
        else:
            kv = (None, b, seq_axes, None, None)
        specs["kv"] = (kv, kv)
    if cfg.arch_type in ("ssm", "hybrid"):
        dims = ssm_dims(cfg)
        heads_ok = _divides(dims.num_heads, m)
        h_axis = MODEL_AXIS if heads_ok else None
        inner_axis = MODEL_AXIS if heads_ok and _divides(dims.d_inner, m) else None
        specs["ssm"] = {
            "h": (None, b, h_axis, None, None),
            "conv_x": (None, b, None, inner_axis),
            "conv_b": (None, b, None, None),
            "conv_c": (None, b, None, None),
        }
    return specs


def decode_shape(batch: int, cache_len: int) -> InputShape:
    """The decode shape of ``batch`` rows against a cache of ``cache_len``
    positions, as :func:`cache_specs` reads it."""
    return InputShape("decode", "decode", cache_len, batch)


def spec_slices(spec, shape, sizes: dict[str, int], coords: dict[str, int]) -> tuple:
    """The slice of each dim a rank at ``coords`` holds of a tensor of
    ``shape`` laid out by ``spec`` (an entry's axes major to minor)."""
    out = []
    for d, entry in zip(shape, spec_entries(spec, len(shape))):
        idx, k = 0, 1
        for name in spec_entry_names(entry):
            idx = idx * sizes.get(name, 1) + coords.get(name, 0)
            k *= sizes.get(name, 1)
        out.append(slice(idx * (d // k), (idx + 1) * (d // k)))
    return tuple(out)


def local_cache_shapes(cfg: ModelConfig, batch: int, cache_len: int, mesh, *,
                       kv_seq_shard: bool = False) -> dict:
    """The shape of each leaf of a rank's decode cache of ``batch`` rows
    and ``cache_len`` positions on ``mesh``: its :func:`cache_specs` shard
    of ``transformer.cache_shapes``, in the same tree (``"kv"``: the (k, v)
    pair; ``"ssm"``: the state's dict)."""
    from repro_torch.models.transformer import cache_shapes

    sizes = mesh_axis_sizes(mesh)
    specs = cache_specs(cfg, decode_shape(batch, cache_len), sizes, kv_seq_shard=kv_seq_shard,
                        cache_len=cache_len)
    shapes = cache_shapes(cfg, batch, cache_len)
    out: dict = {}
    if "kv" in shapes:
        out["kv"] = tuple(local_shape(sp, shape, sizes)
                          for sp, shape in zip(specs["kv"], shapes["kv"]))
    if "ssm" in shapes:
        out["ssm"] = {k: local_shape(specs["ssm"][k], shape, sizes)
                      for k, shape in shapes["ssm"].items()}
    return out


def held_cache_shapes(cache: dict) -> dict:
    """The leaf shapes of a decode cache of tensors, in
    :func:`local_cache_shapes`'s tree."""
    out: dict = {}
    if "kv" in cache:
        out["kv"] = tuple(tuple(t.shape) for t in cache["kv"])
    if "ssm" in cache:
        out["ssm"] = {k: tuple(t.shape) for k, t in cache["ssm"].items()}
    return out


def cache_bytes(shapes: dict, dtype_bytes: int) -> int:
    """The bytes of a decode cache of leaf ``shapes`` (:func:`local_cache_shapes`'s
    tree): ``h`` fp32, the rest ``dtype_bytes`` an element, as
    ``transformer.init_cache`` allocates them."""
    total = sum(math.prod(s) * dtype_bytes for s in shapes.get("kv", ()))
    for k, s in shapes.get("ssm", {}).items():
        total += math.prod(s) * (4 if k == "h" else dtype_bytes)
    return total
