"""Carry parameter trees and optimizer state between the JAX package and the port.

Both packages keep the same stacked ``(L, ...)`` layout under the same path
names, so conversion is leaf for leaf: a reference pytree handed over as
nested dicts of numpy arrays becomes nested dicts of torch tensors, and
back. Tests use it to start both packages from the same weights and to
compare updates leaf by leaf. The optimizer state goes the same way:
Dion's start basis comes from ``jax.random``, which a ``torch.Generator``
cannot reproduce, so parity tests carry the reference's basis over.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.core.dion import DionState
from repro_torch.core.muon import OptState


def params_from_numpy(tree, device="cuda") -> dict:
    """Nested dicts of array-likes -> nested dicts of tensors on ``device``.

    Arrays keep their dtype; every leaf is copied, so the result never
    aliases the caller's buffers.
    """
    return tree_lib.map_with_path(
        lambda _, leaf: torch.from_numpy(np.array(leaf, copy=True)).to(device), tree)


def params_to_numpy(tree) -> dict:
    """Inverse of :func:`params_from_numpy`: float32 numpy leaves on the host.

    bf16 tensors widen to float32, since numpy has no bfloat16.
    """
    def convert(_, leaf):
        t = leaf.detach().to("cpu")
        if t.is_floating_point():
            t = t.to(torch.float32)
        return t.numpy()

    return tree_lib.map_with_path(convert, tree)


def opt_state_from_numpy(state: dict, device="cuda"):
    """The reference's Muon or Dion state -> the port's ``OptState``/``DionState``.

    ``state`` is the reference's state as a dict of its fields (its
    ``_asdict()``) with nested dicts of numpy arrays as trees: ``momentum``,
    ``count`` and, for NorMuon, ``second_moment`` and ``vcount`` (None
    otherwise); or ``momentum``, ``basis`` and ``count`` for Dion. Tensors
    are keyed by path as the port keeps them; counters become host integers.
    """
    def tensors(tree):
        return {path: torch.from_numpy(np.array(leaf, dtype=np.float32, copy=True)).to(device)
                for path, leaf in tree_lib.flatten_with_path(tree)}

    count = int(state["count"])
    if "basis" in state:
        return DionState(momentum=tensors(state["momentum"]), basis=tensors(state["basis"]),
                         count=count)
    second, vcount = state.get("second_moment"), state.get("vcount")
    return OptState(
        momentum=tensors(state["momentum"]), count=count,
        second_moment=None if second is None else tensors(second),
        vcount=None if vcount is None else {
            path: int(c) for path, c in tree_lib.flatten_with_path(vcount)},
    )


def opt_state_to_numpy(state) -> dict:
    """Inverse of :func:`opt_state_from_numpy`: a dict of nested numpy trees.

    Counters come back as int32 scalars, as the reference keeps them.
    """
    def nested(by_path):
        return params_to_numpy(tree_lib.unflatten(list(by_path.items())))

    out = {"momentum": nested(state.momentum), "count": np.int32(state.count)}
    if isinstance(state, DionState):
        out["basis"] = nested(state.basis)
        return out
    out["second_moment"] = None if state.second_moment is None else nested(state.second_moment)
    out["vcount"] = None if state.vcount is None else tree_lib.unflatten(
        [(path, np.int32(c)) for path, c in state.vcount.items()])
    return out
