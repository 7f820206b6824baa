"""Partition specs and MuonBP block grids, dense and MoE, without a mesh.

Counterpart of the dense and MoE rules of ``repro/sharding/specs.py``
(``attn_layouts``, ``param_specs``, ``block_specs_for``). The reference
reads only the mesh's axis names and sizes; here they are a declared
``{axis: size}`` dict, so ``{"model": 8}`` gives the paper's 8-way
tensor-parallel block grids on one GPU (the reference's ``--mesh-model 8``).

A partition spec is a tuple with one entry per dim: ``None`` or an axis
name. Megatron-style rules over the ``model`` axis:

* embeddings vocab-parallel; lm_head column(vocab)-parallel;
* attention: column-parallel wq/wk/wv, row-parallel wo; when the head count
  does not divide the axis the projection shards on head_dim ('hd' layout),
  and when neither divides it is replicated;
* MLP: column-parallel wi/wg, row-parallel wo;
* MoE: the experts' wi/wg column-parallel and wo row-parallel on their
  trailing two dims (the ``(L, E)`` lead dims whole, so each expert's d_ff
  splits), the router replicated;
* norms and everything else replicated.
"""

from __future__ import annotations

from typing import Optional

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.core.blocking import block_spec_from_partition

MODEL_AXIS = "model"


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


def param_specs(params, cfg: ModelConfig, axis_sizes: dict[str, int]) -> dict:
    """Tree of partition-spec tuples matching ``params`` (dense and MoE rules)."""
    m = axis_sizes.get(MODEL_AXIS, 1)
    ql, kvl = attn_layouts(cfg, m)

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
        if "norm" in name:
            return rep(leaf)
        if group == "attn":
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
        return rep(leaf)

    return tree_lib.map_with_path(spec, params)


def block_specs_for(params, specs, axis_sizes: dict[str, int]) -> dict:
    """MuonBP block grid per param: blocks = model-parallel shards."""
    return tree_lib.tree_map(
        lambda p, s: block_spec_from_partition(s, tuple(p.shape), axis_sizes), params, specs
    )
