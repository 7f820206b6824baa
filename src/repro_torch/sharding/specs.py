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
  and the B/C convs replicated, out_proj row-parallel on d_inner;
* norms (gate_norm too: the name rule comes first, as in the reference),
  hymba's attn_scale / ssm_scale and everything else replicated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Union

from repro_torch import tree as tree_lib
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.blocking import block_spec_from_partition
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
# The archs the tensor-parallel path runs.
TP_ARCHS = ("dense", "moe")


def mesh_path(cfg: ModelConfig, axis_sizes) -> str:
    """How a mesh of ranks runs ``cfg``: ``"tensor_parallel"`` (each rank
    holds and computes with its ``param_specs`` shards) or ``"replicated"``
    (each rank holds the whole model; its updates pay the replica gather).

    A dense or MoE model on a ``model`` axis larger than one is
    tensor-parallel; every other arch, and a mesh without a model split, is
    replicated. The port computes the Q heads in the 'head' layout only,
    and the K/V heads in 'head' or, on the tensor-parallel path, 'hd' (the
    reference's ``split_heads``): any other layout raises here, naming it,
    so that no mesh computes another head split than the reference's. The
    tensor-parallel path also needs the padded vocab and ``d_ff`` (an MoE
    model's expert ``d_ff``) to divide the axis (their splits are what its
    collectives assume). The reference keeps the experts replicated where
    their ``d_ff`` does not divide (``repro/models/moe.py:141-145``); the
    port does not run that case and raises, naming the expert ``d_ff``.
    """
    m = mesh_axis_sizes(axis_sizes).get(MODEL_AXIS, 1)
    path = TENSOR_PARALLEL if cfg.arch_type in TP_ARCHS and m > 1 else REPLICATED
    if not cfg.num_heads or cfg.arch_type == "ssm":
        return path
    ql, kvl = attn_layouts(cfg, m)
    allowed_kv = ("head", "hd") if path == TENSOR_PARALLEL else ("head",)
    if ql != "head" or kvl not in allowed_kv:
        raise ValueError(
            f"{cfg.name} on model={m}: Q layout {ql!r}, KV layout {kvl!r} "
            f"({cfg.num_heads} Q / {cfg.num_kv_heads} KV heads of {cfg.head_dim}); the "
            f"{path} path computes Q in 'head' and KV in {' or '.join(map(repr, allowed_kv))}")
    if path == TENSOR_PARALLEL:
        ff = "expert d_ff" if cfg.arch_type == "moe" else "d_ff"
        for name, n in (("padded vocab", cfg.padded_vocab), (ff, cfg.d_ff)):
            if not _divides(n, m):
                raise ValueError(f"{cfg.name} on model={m}: the {name} {n} does not divide "
                                 "the model axis")
    return path


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
    ``seq_shard`` says whether the residual is sequence-sharded. The layouts
    give the head order of the Q and K/V projections' columns
    (``layers.split_heads``), on one device too.
    """

    comm: Any = None
    model_axes: tuple = ()
    size: int = 1
    index: int = 0
    q_layout: str = "head"
    kv_layout: str = "head"
    seq_shard: bool = False

    @property
    def tensor_parallel(self) -> bool:
        return self.size > 1


def make_ctx(cfg: ModelConfig, engine=None, seq: Optional[int] = None) -> ShardCtx:
    """The model's context on the mesh of ``engine``
    (``distributed.engine.ShardMapEngine``) for sequences of ``seq`` tokens:
    tensor-parallel where the engine is (its ``tensor_parallel``), else the
    one-device context (the replicated path). Without an engine, one
    device. An engine built tensor-parallel for a config :func:`mesh_path`
    runs replicated raises."""
    if engine is None or not engine.tensor_parallel:
        return ShardCtx()
    path = mesh_path(cfg, engine.axis_sizes)
    if path != TENSOR_PARALLEL:
        raise ValueError(f"{cfg.name}: the engine is tensor-parallel but the config runs "
                         f"{path} on {engine.axis_sizes}")
    if seq is None:
        raise ValueError("a tensor-parallel context needs the sequence length")
    comm, axes = engine.comm, (MODEL_AXIS,)
    m = comm.size(axes)
    ql, kvl = attn_layouts(cfg, m)
    return ShardCtx(comm=comm, model_axes=axes, size=m, index=comm.index(axes),
                    q_layout=ql, kv_layout=kvl, seq_shard=sequence_sharded(seq, m))


def param_specs(params, cfg: ModelConfig, axis_sizes) -> dict:
    """Tree of partition-spec tuples matching ``params`` (``axis_sizes``: a
    dict or a ``DeviceMesh``)."""
    m = mesh_axis_sizes(axis_sizes).get(MODEL_AXIS, 1)
    ql, kvl = attn_layouts(cfg, m)
    dims = ssm_dims(cfg) if cfg.arch_type in ("ssm", "hybrid") else None
    heads_ok = dims is not None and _divides(dims.num_heads, m)
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
            # head count does not (hymba's 50 heads), as in the reference.
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
