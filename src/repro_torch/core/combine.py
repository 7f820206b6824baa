"""Param-label multi-optimizer: Muon for hidden matrices, AdamW for the rest.

Counterpart of ``repro/core/combine.py``. ``combine`` splits the parameter
tree by a label tree and routes each group to its own optimizer, masking
the others' leaves with ``None``.

Reference quirk kept on purpose: ``default_label_fn`` labels every >=2-D
leaf that is not an embedding ``muon``, so the stacked norm gains
``layers/norms/*_norm`` of shape ``(L, D)`` are orthogonalized whole as
``L x D`` matrices on every phase, exactly as the reference does.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch import tree as tree_lib
from repro_torch.core.muon import Optimizer

LabelFn = Callable[[str, Any], str]


class CombinedState(NamedTuple):
    inner: dict  # label -> sub-optimizer state


def default_label_fn(path: str, leaf) -> str:
    """Paper's split: matrices -> muon; 1D/embeddings/unembeddings -> adamw."""
    lowered = path.lower()
    if len(leaf.shape) < 2:
        return "adamw"
    for token in ("embed", "lm_head", "unembed", "conv", "meta_token"):
        if token in lowered:
            return "adamw"
    return "muon"


def label_tree(params, label_fn: LabelFn = default_label_fn) -> dict:
    return tree_lib.map_with_path(lambda path, leaf: label_fn(tree_lib.path_str(path), leaf), params)


def _mask(tree, labels, label: str):
    return tree_lib.tree_map(lambda x, l: x if l == label else None, tree, labels)


def combine(optimizers: dict[str, Optimizer], labels) -> Optimizer:
    """Combine sub-optimizers; ``labels`` is a tree of strings shaped like params."""
    label_names = sorted(optimizers)

    def init(params):
        return CombinedState(
            inner={name: optimizers[name].init(_mask(params, labels, name)) for name in label_names}
        )

    def update(grads, state: CombinedState, params, phase: str = "block"):
        merged: list = []
        new_inner = {}
        for name in label_names:
            upd, new_state = optimizers[name].update(
                _mask(grads, labels, name), state.inner[name], _mask(params, labels, name), phase
            )
            new_inner[name] = new_state
            merged += tree_lib.flatten_with_path(upd)
        return tree_lib.unflatten(merged), CombinedState(inner=new_inner)

    return Optimizer(init=init, update=update)


def apply_updates(params, updates):
    return tree_lib.tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
