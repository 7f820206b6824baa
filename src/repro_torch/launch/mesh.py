"""Meshes of ranks: ``--mesh`` spec parsing and ``DeviceMesh`` construction.

Counterpart of ``repro/launch/mesh.py``. The reference builds a JAX mesh
over the devices of one process; here every rank is a process (started by
``python -m torch.distributed.run`` or ``torch.multiprocessing.spawn``) and
the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the live
world, with the reference's axis names in its order ``('pod', 'data',
'model')``, row-major: rank ``r`` sits at the coordinates JAX's
``mesh.devices.reshape`` gives device ``r``. Per-axis process groups come
from ``mesh.get_group(name)``. Nothing here initializes the world: the
caller does, with the backend it names.
"""

from __future__ import annotations

import math

MESH_AXES = ("pod", "data", "model")


def parse_mesh_spec(spec: str) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """Parse a ``--mesh`` string into ``(axis_names, shape)``.

    Accepts ``"pod=2,data=2,model=2"`` (named; axes a subset of
    ``('pod', 'data', 'model')``, reordered major to minor) or the
    positional shorthand ``"2,2,2"`` -> pod,data,model / ``"4,2"`` ->
    data,model / ``"8"`` -> data.
    """
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    if not parts:
        raise ValueError(f"empty mesh spec {spec!r}")
    if any("=" in p for p in parts):
        by_axis: dict[str, int] = {}
        for p in parts:
            name, _, size = p.partition("=")
            name = name.strip()
            if name not in MESH_AXES:
                raise ValueError(f"unknown mesh axis {name!r} in {spec!r}; axes are {MESH_AXES}")
            if name in by_axis:
                raise ValueError(f"duplicate mesh axis {name!r} in {spec!r}")
            by_axis[name] = int(size)
        axes = tuple(a for a in MESH_AXES if a in by_axis)
        return axes, tuple(by_axis[a] for a in axes)
    sizes = tuple(int(p) for p in parts)
    if len(sizes) > len(MESH_AXES):
        raise ValueError(
            f"mesh spec {spec!r} has {len(sizes)} entries; max is {len(MESH_AXES)} ({MESH_AXES})")
    # positional: the LAST axes of (pod, data, model) -- "4,2" is data,model
    return MESH_AXES[len(MESH_AXES) - len(sizes):], sizes


def _device_mesh(axes: tuple[str, ...], shape: tuple[int, ...], device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a mesh of ranks needs torch.distributed initialized first")
    n = math.prod(shape)
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(
            f"mesh {dict(zip(axes, shape))} needs {n} ranks, the world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_mesh_from_spec(spec: str, device_type: str = "cpu"):
    """A ``DeviceMesh`` over the live world from a ``--mesh`` spec; the world
    size must equal the mesh's product. Its groups take the world's
    backend; ``device_type`` is "cuda" for NCCL, "cpu" for gloo (which
    also carries CUDA tensors)."""
    axes, shape = parse_mesh_spec(spec)
    return _device_mesh(axes, shape, device_type)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """The reference's production mesh over the live world: ``(data=16,
    model=16)`` (one pod of 256), or ``(pod=2, data=16, model=16)`` with
    ``multi_pod``; the world size must be the mesh's product (the dry-run's
    fake world, ``launch/dryrun.py``). Initializes nothing."""
    if multi_pod:
        return _device_mesh(MESH_AXES, (2, 16, 16), device_type)
    return _device_mesh(("data", "model"), (16, 16), device_type)


def make_local_mesh(model: int | None = None, data: int | None = None,
                    pod: int | None = None, device_type: str = "cpu"):
    """A mesh over the whole live world (tests, small runs): hierarchical
    ``('pod', 'data', 'model')`` with ``pod``, else ``('data', 'model')``;
    ``data`` defaults to what the world leaves."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_initialized() else 1
    model = 1 if model is None else model
    if pod:
        if data is None:
            data = n // (model * pod)
        return _device_mesh(MESH_AXES, (pod, data, model), device_type)
    if data is None:
        data = n // model
    return _device_mesh(("data", "model"), (data, model), device_type)
