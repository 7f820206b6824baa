"""A mesh run's bytes a rank and step, from the shapes alone.

What the launcher under ``--mesh`` will move, counted before it runs (the
parameters are fake tensors: no memory, no device): the path
(``sharding.specs.mesh_path``), the parameters a rank holds, and by trace
phase the bytes ``plan_comm`` predicts for the optimizer (``block``,
``full``, ``apply``), ``dion_bytes`` for Dion's factor products a step
(``--optimizer dion`` pays these and ``apply`` in place of
``block``/``full``), ``tp_bytes`` for the tensor-parallel
forward and backward with each layer's recompute (the VLM's vision tokens
and whisper's encoder included), and the
gradient reduce (every gradient a rank holds, then one vector of the loss
and its metrics). No step moves a replica gather. A run's trace equals
these to the byte (``chip_smoke.py``'s ``distributed``
phase checks the same counts, taken from the run; the launcher's
activations are bf16, ``compute_bytes=2``).

  PYTHONPATH=src python -m repro_torch.scripts.mesh_bytes --arch mamba2-1.3b \\
      --layers 8 --mesh data=2,model=2 --zero1 --batch 4 --seq 1024

With ``--cache-len T`` it also prints, from ``tp_bytes(mode=...)``, the
``'tp'`` bytes a rank of one tensor-parallel prefill of ``--batch`` x
``--seq`` tokens into a decode cache of ``T`` positions (``tp_prefill``)
and of one decode step against it (``tp_decode``), the cache laid out by
``sharding.specs.cache_specs`` (``--kv-seq-shard`` as it takes it; a batch
that no data axis divides splits the cache's sequence over them; on a mesh
without a model split only that split's merge moves bytes), and the
bytes of a rank's cache (``cache_a_rank``, in the activations' dtype,
``h`` fp32). gemma2-9b's decode step at ``decode_32k`` (128 rows, 32768
positions, bf16) on ``data=16,model=16``, where its 8 KV heads lay out
'hd' and each layer gathers the cache's head_dim slices every step,
against the cache's sequence over ``model``, which merges the softmax
instead:

  python -m repro_torch.scripts.mesh_bytes --arch gemma2-9b --mesh data=16,model=16 \\
      --batch 128 --seq 32768 --cache-len 32768 [--kv-seq-shard]

prints ``"tp_decode": 90201939968`` (2 x 8 rows x 32768 x 2048 x 2 B, 2.1 GB
a layer, gathered over ``model``) and with ``--kv-seq-shard``
``"tp_decode": 15927296`` (the Q and fresh K/V columns and the merge,
377856 B a layer), ``"cache_a_rank": 5637144576`` both.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
from typing import Optional

from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.distributed import dion_bytes, plan_comm, tp_bytes
from repro_torch.launch.mesh import parse_mesh_spec
from repro_torch.launch.train import matrix_block_specs
from repro_torch.models.transformer import init_params
from repro_torch.sharding import specs as sh


def mesh_bytes(cfg, sizes: dict, *, batch: int, seq: int, zero1: bool = False,
               compute_bytes: int = 2, cache_len: Optional[int] = None,
               kv_seq_shard: bool = False) -> dict:
    """The counts of the module doc for ``cfg`` on a mesh of ``sizes``
    (``{axis: size}``), ``batch`` rows of ``seq`` text tokens over the
    mesh; with ``cache_len``, a prefill's and a decode step's and the
    cache's. ``whole`` names the sub-blocks the model axis leaves whole
    on every rank (``sharding.specs.whole_sub_blocks``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = init_params(cfg, device="cpu")
    path = sh.mesh_path(cfg, sizes)
    specs = sh.param_specs(params, cfg, sizes)
    plan = plan_comm(params, specs, sizes, block_specs=matrix_block_specs(params, cfg, sizes),
                     zero1=zero1)
    tp = path == sh.TENSOR_PARALLEL
    held = sum(math.prod(sh.local_shape(s, p.shape, sizes) if tp else p.shape)
               for p, s in zip(tree_lib.leaves(params), tree_lib.leaves(specs)))
    data = math.prod(v for a, v in sizes.items() if a != sh.MODEL_AXIS)
    # The loss, then each metric: ce, loss, and an MoE model's load_balance and z_loss.
    values = 3 + (2 if cfg.num_experts else 0)
    serve = {}
    if cache_len is not None:
        rows = batch // math.prod(sizes[a] for a in sh.batch_axes_for(batch, sizes))
        kw = dict(batch=batch, kv_seq_shard=kv_seq_shard, compute_bytes=compute_bytes)
        serve = {
            "tp_prefill": tp_bytes(cfg, rows, seq, sizes, mode="prefill", cache_len=cache_len,
                                   **kw),
            "tp_decode": tp_bytes(cfg, rows, cache_len, sizes, mode="decode", **kw),
            "cache_a_rank": sh.cache_bytes(sh.local_cache_shapes(
                cfg, batch, cache_len, sizes, kv_seq_shard=kv_seq_shard), compute_bytes),
        }
    return {
        "path": path,
        "whole": [k for k, v in sh.whole_sub_blocks(cfg, sizes).items() if v],
        "params": sum(p.numel() for p in tree_lib.leaves(params)),
        "params_a_rank": held,
        **{ph: plan.predicted_bytes(ph) for ph in ("block", "full", "apply")},
        "dion": dion_bytes(params, specs, sizes, zero1=zero1),
        "tp": tp_bytes(cfg, batch // data, seq, sizes, compute_bytes=compute_bytes),
        "grad_reduce": 4 * (held + values) if data > 1 else 0,
        **serve,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, default=None, help="cut the depth")
    ap.add_argument("--mesh", required=True)
    ap.add_argument("--batch", type=int, required=True, help="global rows")
    ap.add_argument("--seq", type=int, required=True)
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--cache-len", type=int, default=None,
                    help="also a prefill into and a decode step against a cache this long")
    ap.add_argument("--kv-seq-shard", action="store_true")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    sizes = dict(zip(*parse_mesh_spec(args.mesh)))
    print(json.dumps(mesh_bytes(cfg, sizes, batch=args.batch, seq=args.seq, zero1=args.zero1,
                                cache_len=args.cache_len, kv_seq_shard=args.kv_seq_shard)))


if __name__ == "__main__":
    main()
