"""Carry parameter trees between the JAX package and the port.

Both packages keep the same stacked ``(L, ...)`` layout under the same path
names, so conversion is leaf for leaf: a reference pytree handed over as
nested dicts of numpy arrays becomes nested dicts of torch tensors, and
back. Tests use it to start both packages from the same weights and to
compare updates leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as tree_lib


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
