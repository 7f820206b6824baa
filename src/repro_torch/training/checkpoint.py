"""Durable checkpointing: atomic, checksummed .npz snapshots and auto-resume.

Counterpart of ``repro/training/checkpoint.py``, with its on-disk format
letter for letter, so a snapshot written by either package restores into
the other: a directory of ``params.npz``, ``opt_state.npz`` and
``meta.json`` (``"format": 2``, a per-array CRC32 manifest under
``"checksums"``). The npz keys are the reference's: the ``/``-joined
pytree path that ``jax.tree_util`` gives each leaf of the reference's state,
``.inner/adamw/.mu/embed`` or ``.inner/muon/.momentum/layers/mlp/wo``.
The port's state types keep their tensors in flat dicts keyed by path and
their counters as host integers, so :data:`_FIELDS` spells out, type by
type, the reference's field names, their order and what each holds; the
keys are built from that map, not from the port's own layout.

Durability contract (why a kill can't eat a run):

* **Atomic writes** -- :func:`save` stages the whole snapshot in a sibling
  ``*.tmp.*`` directory, fsyncs every file and the directory, then renames
  it into place. A SIGKILL at any point leaves either the old snapshot or
  the new one, never a half-written hybrid (exercised by
  ``faults.crash_point``, which SIGKILLs from inside this function).
* **Checksums** -- :func:`verify` recomputes the CRC32 manifest, so
  disk-level damage (bit-flips, truncation) is rejected instead of loaded.
* **Snapshot roots** -- :func:`save_snapshot` writes immutable
  ``step_XXXXXXXX/`` directories under a root with last-``keep`` retention;
  :func:`latest_valid` walks them newest-first and *skips* any snapshot
  that fails verification (the restore fallback chain).
* **Run metadata** -- the launcher records arch/optimizer/mesh/period under
  ``meta['run']``; restore checks it against the resuming process so a
  wrong-arch resume fails with a named mismatch, not a shape error.

Tensors are copied to the host to be written; :func:`restore` puts each
leaf on a given device (default: the template leaf's).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import zlib
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.adamw import AdamWState
from repro_torch.core.combine import CombinedState
from repro_torch.core.dion import DionState
from repro_torch.core.muon import OptState
from repro_torch.training import faults

META = "meta.json"
_ARRAY_FILES = ("params.npz", "opt_state.npz")
_SNAP_RE = re.compile(r"^step_(\d{8,})$")

# The reference's state types, field by field in their NamedTuple order:
# "node" is a subtree (a dict keyed by name), "by_path" a dict keyed by
# parameter path (each value one leaf), "leaf" a single value. A field that
# is None is an empty subtree, as in JAX, and has no key.
_FIELDS: dict[type, tuple[tuple[str, str], ...]] = {
    CombinedState: (("inner", "node"),),
    AdamWState: (("mu", "by_path"), ("nu", "by_path"), ("count", "leaf")),
    OptState: (("momentum", "by_path"), ("count", "leaf"),
               ("second_moment", "by_path"), ("vcount", "by_path")),
    DionState: (("momentum", "by_path"), ("basis", "by_path"), ("count", "leaf")),
}


class CheckpointError(RuntimeError):
    """A snapshot is unreadable, corrupt, or doesn't match this run."""


def map_leaves(fn: Callable[[str, Any], Any], tree, parts: tuple = ()):
    """Rebuild ``tree`` with ``fn(key, leaf)`` at every leaf.

    ``key`` is the reference's checkpoint key of the leaf; leaves are
    visited in the reference's order (fields in order, dict keys sorted).
    """
    if tree is None:
        return None
    fields = _FIELDS.get(type(tree))
    if fields is not None:
        new = {}
        for name, kind in fields:
            value = getattr(tree, name)
            at = parts + ("." + name,)
            if value is None:
                new[name] = None
            elif kind == "node":
                new[name] = map_leaves(fn, value, at)
            elif kind == "by_path":
                new[name] = {path: fn("/".join(at + tuple(path)), value[path])
                             for path in sorted(value)}
            else:
                new[name] = fn("/".join(at), value)
        return type(tree)(**new)
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k], parts + (str(k),)) for k in sorted(tree)}
    return fn("/".join(parts), tree)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu").numpy()
    if isinstance(leaf, (bool, int)):
        return np.asarray(leaf, np.int32)  # host counters: the reference's int32 scalars
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}
    map_leaves(lambda key, leaf: flat.__setitem__(key, _host(leaf)), tree)
    return flat


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_npz(path: str, flat: dict[str, np.ndarray], prefix: str,
               checksums: dict[str, int]) -> None:
    with open(path, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    for k, arr in flat.items():
        checksums[f"{prefix}/{k}"] = _crc(arr)


def save(path: str, params: Any, opt_state: Any = None, step: int = 0,
         extra: Optional[dict] = None):
    """Write one snapshot directory atomically (tmp dir + fsync + rename).

    ``extra`` merges into ``meta.json``: the launcher puts run metadata
    under ``extra['run']`` (checked on resume) and free-form state like the
    data-pipeline RNG under its own keys. Replacing an *existing* ``path``
    swaps directories (old -> aside, tmp -> path); the snapshot-root flow
    (:func:`save_snapshot`) writes immutable per-step dirs instead.
    """
    path = os.path.abspath(path)
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(path) + ".tmp.", dir=parent)
    try:
        checksums: dict[str, int] = {}
        _write_npz(os.path.join(tmp, "params.npz"), _flatten(params), "params", checksums)
        faults.crash_point("checkpoint.mid_write", step)
        if opt_state is not None:
            _write_npz(os.path.join(tmp, "opt_state.npz"), _flatten(opt_state), "opt_state",
                       checksums)
        meta = {"step": int(step), "format": 2, "checksums": checksums}
        if extra:
            meta.update(extra)
        with open(os.path.join(tmp, META), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_path(tmp)
        faults.crash_point("checkpoint.pre_finalize", step)
        if os.path.exists(path):
            # rename(2) replaces an *empty* target dir, so stage the old
            # snapshot aside through one before removing it.
            aside = tempfile.mkdtemp(prefix=os.path.basename(path) + ".old.", dir=parent)
            os.rename(path, aside)
            os.rename(tmp, path)
            shutil.rmtree(aside, ignore_errors=True)
        else:
            os.rename(tmp, path)
        _fsync_path(parent)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_meta(path: str) -> dict:
    meta_path = os.path.join(path, META)
    if not os.path.exists(meta_path):
        raise CheckpointError(f"{path}: no {META}")
    try:
        with open(meta_path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointError(f"{path}: unreadable {META}: {e}") from e


def _load_arrays(path: str, fname: str) -> dict[str, np.ndarray]:
    try:
        return dict(np.load(os.path.join(path, fname)))
    except Exception as e:  # zipfile/format errors vary; all mean "corrupt"
        raise CheckpointError(f"{path}: unreadable {fname}: {e}") from e


def verify(path: str, expect_run: Optional[dict] = None) -> dict:
    """Validate a snapshot end to end; returns its meta dict.

    Checks: meta.json parses, every array file named by the checksum
    manifest exists and unzips, every manifest entry's CRC32 matches the
    stored bytes, and no stored array is missing from the manifest.
    Snapshots without a manifest (format 1) pass with a readability check
    only. With ``expect_run``, run metadata is matched too.
    """
    meta = load_meta(path)
    checksums = meta.get("checksums")
    for fname in _ARRAY_FILES:
        prefix = fname[:-len(".npz")]
        fpath = os.path.join(path, fname)
        manifest = (
            {k.split("/", 1)[1]: v for k, v in checksums.items() if k.startswith(prefix + "/")}
            if checksums is not None else None
        )
        if not os.path.exists(fpath):
            if manifest:
                raise CheckpointError(
                    f"{path}: {fname} missing but manifest lists {len(manifest)} arrays for it")
            continue
        flat = _load_arrays(path, fname)
        if manifest is None:
            continue  # format 1: no manifest
        missing = sorted(set(manifest) - set(flat))
        extra = sorted(set(flat) - set(manifest))
        if missing or extra:
            raise CheckpointError(
                f"{path}: {fname} does not match its checksum manifest -- "
                f"missing {missing[:5]}{'...' if len(missing) > 5 else ''}, "
                f"unexpected {extra[:5]}{'...' if len(extra) > 5 else ''}"
            )
        for k, arr in flat.items():
            got = _crc(arr)
            if got != manifest[k]:
                raise CheckpointError(
                    f"{path}: CRC32 mismatch in {fname} at {k!r}: "
                    f"stored {manifest[k]:#010x}, recomputed {got:#010x} "
                    f"(bit-flip or torn write)"
                )
    if expect_run is not None:
        check_run_meta(meta, expect_run, path=path)
    return meta


def check_run_meta(meta: dict, expect: dict, path: str = "<snapshot>") -> None:
    """Match a snapshot's ``meta['run']`` against the resuming run's values.

    Only keys present on both sides are compared; any disagreement raises
    with every mismatch named. The launcher's ``schedule`` entry (``mode``,
    ``period`` and the staggered schedule's per-leaf ``offsets``) compares
    as a whole after the snapshot's JSON round trip, so a staggered
    snapshot refuses a synchronous resume, another period or another
    offset map, and the reverse.
    """
    run = meta.get("run") or {}
    mismatches = {k: (run[k], v) for k, v in expect.items() if k in run and run[k] != v}
    if mismatches:
        lines = ", ".join(f"{k}: snapshot={a!r} run={b!r}" for k, (a, b) in mismatches.items())
        raise CheckpointError(
            f"{path}: run metadata mismatch -- {lines}. Refusing to resume a "
            f"different run's checkpoint."
        )


def _fit_lead(arr: np.ndarray, shape: tuple, key: str) -> np.ndarray:
    """A state leaf saved with (or without) the ZeRO-1 flatten fallback's
    zero pad layers, fit to ``shape``'s lead dim: pad layers are dropped
    (they must be zero) or added as zeros."""
    if arr.shape == shape or not shape or arr.shape[1:] != shape[1:]:
        return arr
    if arr.shape[0] > shape[0]:
        if np.any(arr[shape[0]:]):
            raise ValueError(f"checkpoint leaf {key} has nonzero rows past lead {shape[0]}")
        return arr[:shape[0]]
    return np.concatenate([arr, np.zeros((shape[0] - arr.shape[0], *arr.shape[1:]),
                                         arr.dtype)])


def _restore_leaf(arr: np.ndarray, leaf, key: str, device, sharding=None, engine=None):
    shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
    if sharding is not None and isinstance(leaf, torch.Tensor):
        # A rank's shard: fit the full array to the leaf's full shape on
        # this mesh, then cut this rank's piece as zero1.shard_state does.
        from repro_torch.distributed.zero1 import shard_leaf

        full = torch.from_numpy(_fit_lead(arr, tuple(sharding.shape), key))
        out = shard_leaf(full, sharding, engine).to(
            device=leaf.device if device is None else device, dtype=leaf.dtype)
        if tuple(out.shape) != shape:
            raise ValueError(f"checkpoint shard shape mismatch at {key}: "
                             f"{tuple(out.shape)} vs {shape}")
        return out
    if key.startswith(".") or "/." in key:
        arr = _fit_lead(arr, shape, key)  # optimizer state: mesh-independent leads
    if arr.shape != shape:
        raise ValueError(f"checkpoint shape mismatch at {key}: {arr.shape} vs {shape}")
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(np.array(arr, copy=True)).to(
            device=leaf.device if device is None else device, dtype=leaf.dtype)
    if isinstance(leaf, (bool, int)):
        return int(arr)
    return arr.astype(np.asarray(leaf).dtype)


def _unflatten_into(template, flat: dict[str, np.ndarray], device=None,
                    source: str = "checkpoint", shardings=None, engine=None):
    keys: list[str] = []
    map_leaves(lambda key, leaf: keys.append(key), template)
    missing = sorted(set(keys) - set(flat))
    unexpected = sorted(set(flat) - set(keys))
    if missing or unexpected:
        raise CheckpointError(
            f"{source}: array keys do not match the restore template "
            f"(truncated checkpoint or architecture mismatch).\n"
            f"  missing from checkpoint ({len(missing)}): {missing[:8]}"
            f"{'...' if len(missing) > 8 else ''}\n"
            f"  unexpected in checkpoint ({len(unexpected)}): {unexpected[:8]}"
            f"{'...' if len(unexpected) > 8 else ''}"
        )
    by_key: dict = {}
    if shardings is not None:
        map_leaves(lambda key, s: by_key.__setitem__(key, s), shardings)
    return map_leaves(lambda key, leaf: _restore_leaf(flat[key], leaf, key, device,
                                                      by_key.get(key), engine), template)


def restore(path: str, params_template: Any, opt_template: Any = None, *, device=None,
            verify_checksums: bool = True, expect_run: Optional[dict] = None,
            opt_shardings: Any = None, engine: Any = None):
    """Returns (params, opt_state or None, step).

    The templates give the structure, shapes and dtypes (a fresh
    ``init_train_state`` does); each tensor lands on ``device``, or on its
    template leaf's device when ``device`` is None. Verifies the snapshot's
    checksum manifest first (``verify_checksums=False`` skips the CRC pass,
    e.g. after an explicit :func:`verify`) and, with ``expect_run``, the run
    metadata.

    Snapshots are mesh-independent: the parameters and the optimizer state
    are saved as full leaves (``distributed.zero1.gather_params`` and
    ``gather_state``). With ``opt_shardings``
    (``distributed.zero1.opt_shardings`` of the template) and the
    ``engine``, each full leaf is cut to the template's shard on this rank;
    on the tensor-parallel path (``engine.tensor_parallel``) each
    parameter is cut to its param-layout shard the same way.
    An optimizer leaf saved with or without the flatten fallback's zero pad
    layers is fit to the template's lead dim either way.
    """
    if verify_checksums:
        verify(path, expect_run=expect_run)
    elif expect_run is not None:
        check_run_meta(load_meta(path), expect_run, path=path)
    param_shardings = None
    if engine is not None:
        from repro_torch.distributed.zero1 import param_shardings as _param_shardings

        param_shardings = _param_shardings(params_template, engine)
    params = _unflatten_into(params_template, _load_arrays(path, "params.npz"), device,
                             source=os.path.join(path, "params.npz"),
                             shardings=param_shardings, engine=engine)
    opt_state = None
    opt_file = os.path.join(path, "opt_state.npz")
    if opt_template is not None and os.path.exists(opt_file):
        opt_state = _unflatten_into(opt_template, _load_arrays(path, "opt_state.npz"), device,
                                    source=opt_file, shardings=opt_shardings, engine=engine)
    return params, opt_state, load_meta(path)["step"]


# ---------------------------------------------------------------------------
# Snapshot roots: immutable per-step dirs, retention, restore fallback chain
# ---------------------------------------------------------------------------

def snapshot_path(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def list_snapshots(root: str) -> list[tuple[int, str]]:
    """(step, path) of every snapshot dir under ``root``, ascending by step."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = _SNAP_RE.match(name)
        if m and os.path.isdir(os.path.join(root, name)):
            out.append((int(m.group(1)), os.path.join(root, name)))
    return sorted(out)


def save_snapshot(root: str, params: Any, opt_state: Any = None, step: int = 0,
                  extra: Optional[dict] = None, keep: Optional[int] = None) -> str:
    """Atomically write ``root/step_XXXXXXXX`` and prune to the last ``keep``.

    Retention runs *after* the new snapshot is durable, so a crash during
    pruning can only leave extra snapshots, never fewer.
    """
    path = snapshot_path(root, step)
    save(path, params, opt_state, step=step, extra=extra)
    if keep:
        prune_snapshots(root, keep)
    return path


def prune_snapshots(root: str, keep: int) -> list[str]:
    """Remove all but the newest ``keep`` snapshots and stale tmp/aside dirs
    left by killed saves. Returns the removed paths."""
    removed = []
    snaps = list_snapshots(root)
    for _, path in snaps[:-keep] if keep else []:
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
    live = {os.path.basename(p) for _, p in snaps[-keep:]} if keep else set()
    for name in os.listdir(root) if os.path.isdir(root) else []:
        if (".tmp." in name or ".old." in name) and name not in live:
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
            removed.append(os.path.join(root, name))
    return removed


def latest_valid(root: str, expect_run: Optional[dict] = None,
                 on_skip: Optional[Callable[[str, str], None]] = None):
    """Newest snapshot under ``root`` that passes :func:`verify`.

    Snapshots are tried newest-first and any that fail verification
    (corrupt, torn, wrong run) are *skipped* -- ``on_skip(path, reason)`` is
    called for each -- so one bad snapshot degrades to the previous one.
    Returns ``(path, meta)`` or ``None`` when nothing valid exists.
    """
    for _, path in reversed(list_snapshots(root)):
        try:
            return path, verify(path, expect_run=expect_run)
        except CheckpointError as e:
            if on_skip is not None:
                on_skip(path, str(e))
    return None
