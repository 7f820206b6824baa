"""ZeRO-1 optimizer-state sharding over the data axes.

Counterpart of ``repro/distributed/zero1.py``. The optimizer-state layout
follows the param layout by path-suffix matching (the momentum trees mirror
the param tree inside ``OptState`` / ``CombinedState``; Dion's basis,
``(..., n, r)``, is split on ``n`` as its momentum's columns); the ZeRO-1 rule is
``sharding.specs.momentum_spec``: split the lead dim over the data axes
where it divides (for Muon leaves only a stack dim, ndim >= 3; AdamW's
coordinate-wise state from ndim 2, so the embedding and head moments
split too). A leaf of the flatten fallback is recognized by its padded lead
dim, a NorMuon row statistic by its collapsed last dim; leaves with no
param match (step counters) are replicated.

  * :func:`opt_specs` -- the spec tree of an optimizer state (full-shaped or
    a rank's shards);
  * :func:`opt_shardings` -- each leaf's ``(spec, full_shape)``, what
    ``training.checkpoint.restore`` cuts a full snapshot leaf by;
  * :func:`shard_state` -- cut a full state into this rank's shards, leaf by
    leaf through :func:`shard_leaf`, the one cut that
    ``training.checkpoint.restore`` makes too;
  * :func:`gather_state` -- the full state from every rank's shards (a
    snapshot's save);
  * :func:`param_shardings` / :func:`gather_params` -- the same for the
    parameters of the tensor-parallel path, which each rank holds in their
    param layout.

The reference's ``attach`` (abstract state with shardings for its dry
run) and ``constrain`` (a sharding constraint inside a compiled step) have
no meaning in eager PyTorch, where each rank allocates and keeps only its
shards: ``muon.init`` / ``adamw.init`` with ``comm=`` do that.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.sharding import specs as sh
from repro_torch.training.checkpoint import map_leaves

class LeafSharding(NamedTuple):
    """An optimizer-state leaf's spec and its full (global) shape."""

    spec: tuple
    shape: tuple


def _match_suffix(key: str, index: dict):
    """Longest param-path suffix of an opt-state key present in ``index``
    (the key's field components, ``.momentum`` etc., never match)."""
    parts = key.split("/")
    for start in range(len(parts)):
        cand = tuple(parts[start:])
        if cand in index:
            return cand
    return None


def _layout(engine, key: str, leaf, index: dict) -> LeafSharding:
    """The sharding of one leaf: momentum-like, row statistic, or replicated."""
    shape = tuple(getattr(leaf, "shape", ()))
    rep = LeafSharding((None,) * len(shape), shape)
    path = _match_suffix(key, index)
    if path is None or len(index[path]) != len(shape):
        return rep
    sizes = engine.axis_sizes
    state = engine.state_shape_for(path, index[path])
    spec = engine.spec_for(path, len(state))
    if len(state) >= 2 and ".basis" in key.split("/"):
        # Dion's basis (..., n, r): n split as the momentum's columns.
        from repro_torch.core.dion import basis_spec

        return LeafSharding(basis_spec(spec), (*state[:-2], state[-1], shape[-1]))
    candidates = [LeafSharding(spec, state)]
    if len(state) >= 2:
        candidates.append(LeafSharding((*spec[:-1], None), (*state[:-1], 1)))
    for cand in candidates:
        if shape in (cand.shape, sh.local_shape(cand.spec, cand.shape, sizes)):
            return cand
    return rep


def opt_shardings(a_opt: Any, a_params: Any, engine) -> Any:
    """``LeafSharding`` per leaf of ``a_opt`` (full-shaped or local shards),
    from the engine's momentum specs (``a_params`` as the ranks hold them)."""
    index = {path: engine.full_shape(path, p.shape)
             for path, p in tree_lib.flatten_with_path(a_params)}
    return map_leaves(lambda key, leaf: _layout(engine, key, leaf, index), a_opt)


def opt_specs(a_opt: Any, a_params: Any, mesh, *, pspecs: Any, zero1: bool = False,
              axis=None, zero1_flatten: bool = False) -> Any:
    """Spec tuple per leaf of ``a_opt``, from the mesh's axis sizes
    (``a_params`` with the global shapes, as the reference's)."""
    from repro_torch.distributed.engine import make_engine

    engine = make_engine(a_params, pspecs, sh.mesh_axis_sizes(mesh), zero1=zero1,
                         zero1_axis=axis, zero1_flatten=zero1_flatten)
    index = {path: tuple(p.shape) for path, p in tree_lib.flatten_with_path(a_params)}
    return map_leaves(lambda key, leaf: _layout(engine, key, leaf, index).spec, a_opt)


def _zip_map(fn, tree, layouts):
    """``fn(leaf, layout)`` over the leaves of ``tree`` and ``layouts``."""
    flat: dict = {}
    map_leaves(lambda key, s: flat.__setitem__(key, s), layouts)
    return map_leaves(lambda key, leaf: fn(leaf, flat[key]), tree)


def shard_leaf(x: torch.Tensor, layout: LeafSharding, engine) -> torch.Tensor:
    """This rank's shard (a copy) of the full leaf ``x`` under its layout."""
    return engine.cut(x, layout.spec).clone()


def shard_state(opt_state: Any, a_params: Any, engine) -> Any:
    """Cut a full optimizer state into this rank's shards."""
    layouts = opt_shardings(opt_state, a_params, engine)
    return _zip_map(lambda x, s: shard_leaf(x, s, engine)
                    if isinstance(x, torch.Tensor) else x, opt_state, layouts)


def gather_state(opt_state: Any, a_params: Any, engine, *,
                 phase: str = "checkpoint") -> Any:
    """The full optimizer state from every rank's shards (every rank gets
    it; the flatten fallback's leaves keep their pad)."""
    layouts = opt_shardings(opt_state, a_params, engine)
    return _zip_map(lambda x, s: engine.join(x, s.spec, phase=phase)
                    if isinstance(x, torch.Tensor) else x, opt_state, layouts)


def param_shardings(a_params: Any, engine) -> Any:
    """``LeafSharding`` (param spec, global shape) per parameter on the
    tensor-parallel path; None on the replicated path, whose ranks hold
    every parameter whole."""
    if not engine.tensor_parallel:
        return None
    return tree_lib.map_with_path(
        lambda path, p: LeafSharding(engine.pspec_by_path[path],
                                     engine.full_shape(path, p.shape)), a_params)


def gather_params(params: Any, engine, *, phase: str = "checkpoint") -> Any:
    """The full parameters from every rank's param-layout shards (every rank
    gets them); the tree itself on the replicated path."""
    if not engine.tensor_parallel:
        return params
    return tree_lib.map_with_path(
        lambda path, p: engine.join(p, engine.pspec_by_path[path], phase=phase), params)


def state_bytes(opt_state: Any) -> int:
    """Bytes of every tensor of an optimizer state (a rank's, when sharded)."""
    total = [0]
    map_leaves(lambda key, x: total.__setitem__(0, total[0] + x.numel() * x.element_size())
               if isinstance(x, torch.Tensor) else None, opt_state)
    return total[0]
