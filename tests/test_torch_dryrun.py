"""The port's dry-run and perf runner (``repro_torch.launch.dryrun``,
``repro_torch.launch.perf``): one rank of a fake world.

The fake world lives in one spawned child process (a module fixture), which
runs every case and hands back the records:

* reduced muonbp-960m ``train_smoke`` on ``pod=2,data=2,model=2``: block,
  full and the three optimizer variants, named as the reference named its
  five committed records (``experiments/dryrun/``), with the reference's
  record keys; the block step moves no optimizer byte, the full step's
  gathers equal ``plan_comm``'s, ``tp`` equals ``tp_bytes`` and
  ``grad_reduce`` every gradient a rank holds and the loss's vector;
* the full step on ``--device cpu`` against ``fake``: the same collectives,
  FLOPs and argument bytes;
* tensor-parallel prefill and decode (reduced gemma2-9b with
  ``kv_seq_shard``, reduced mixtral-8x7b with ``ring_cache``): the cache
  a rank holds equals ``specs.cache_bytes(local_cache_shapes(...))`` and
  ``tp`` equals ``tp_bytes(mode=...)``;
* ``make_production_mesh`` on fake worlds of 256 and 512;
* the perf CLI writes its record (``--layer-shard``: the fold's gathers
  on top of the plan's).

In this process: ``get_shape``/``shape_applies`` against the reference's
over every arch and shape, and ``long_500k`` on a full-attention arch
skipped with the reference's reason. The reference's own dry-run module is
never imported here (it forces 512 XLA host devices at import).
"""

import json
import math
import os
import traceback

import pytest
import torch.multiprocessing as mp
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import get_shape as j_get_shape
from repro.configs import shape_applies as j_shape_applies
from repro_torch.configs import ARCHS, SHAPES, get_config, get_shape, shape_applies
from repro_torch.launch import dryrun

ROOT = os.path.join(os.path.dirname(__file__), "..")
MESH = "pod=2,data=2,model=2"
SIZES = {"pod": 2, "data": 2, "model": 2}
VARIANTS = ("dion", "normuon", "turbo_muon")
# The reference record's keys; lower_s and compile_s become build_s and step_s.
REF_KEYS = {"arch", "shape", "mesh", "mesh_axes", "phase", "kind", "memory", "cost",
            "collectives", "collective_bytes_total", "calibrated", "variant"}
SERVE = {  # (arch, kind, seq, rows, variant)
    "prefill_kv_seq": ("gemma2-9b", "prefill", 64, 8, {"kv_seq_shard": True}),
    "decode_kv_seq": ("gemma2-9b", "decode", 64, 8, {"kv_seq_shard": True}),
    "decode_ring": ("mixtral-8x7b", "decode", 128, 8, {"ring_cache": True}),
}


def _child(out_dir: str, queue) -> None:
    """Every case that needs the fake world; the results to ``queue``."""
    try:
        import torch

        torch.set_num_threads(1)
        queue.put(_cases(out_dir))
    except BaseException:
        queue.put({"error": traceback.format_exc()})


def _cases(out_dir: str) -> dict:
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import perf
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding import specs as sh

    out: dict = {"train": {}, "serve": {}}
    recs = out["train"]
    for phase in ("block", "full"):
        recs[phase] = dryrun.run_and_save("muonbp-960m", "train_smoke", False, phase,
                                          skip_existing=False, mesh_spec=MESH, reduced=True,
                                          device="fake", results_dir=out_dir)
    for v in VARIANTS:
        recs[v] = dryrun.run_and_save("muonbp-960m", "train_smoke", False, "full",
                                      skip_existing=False, variant={"optimizer_variant": v},
                                      mesh_spec=MESH, reduced=True, device="fake",
                                      results_dir=out_dir)
    recs["cpu_full"] = dryrun.lower_combo("muonbp-960m", "train_smoke", phase="full",
                                          mesh_spec=MESH, reduced=True, device="cpu")
    mesh = dryrun.build_mesh(mesh_spec=MESH)
    for name, (arch, kind, seq, rows, variant) in SERVE.items():
        cfg = get_config(arch).reduced()
        rec = dryrun._lower(cfg, InputShape(name, kind, seq, rows), mesh, "block", 5,
                            variant, "fake")
        rec["cache_len"] = cfg.window_size if variant.get("ring_cache") else seq
        out["serve"][name] = rec
    sizes = {}
    for multi_pod in (False, True):
        dryrun.join_fake_world(512 if multi_pod else 256, 0)
        sizes[multi_pod] = sh.mesh_axis_sizes(make_production_mesh(multi_pod=multi_pod))
    try:
        make_production_mesh()
        out["mesh_mismatch"] = None
    except RuntimeError as e:
        out["mesh_mismatch"] = str(e)
    out["production"] = {str(k): v for k, v in sizes.items()}
    perf.main(["--arch", "muonbp-960m", "--shape", "train_smoke", "--mesh", MESH, "--reduced",
               "--phase", "full", "--layer-shard", "--device", "fake", "--results-dir",
               out_dir, "--name", "ls"])
    return out


@pytest.fixture(scope="module")
def fake_world(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("dryrun"))
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=_child, args=(out_dir, queue))
    proc.start()
    res = queue.get(timeout=600)
    proc.join()
    assert "error" not in res, res["error"]
    return res, out_dir


def _plan(cfg):
    from repro_torch.distributed import plan_comm
    from repro_torch.sharding import specs as sh

    full = dryrun.abstract_params(cfg)
    pspecs = sh.param_specs(full, cfg, SIZES)
    return full, plan_comm(full, pspecs, SIZES, block_specs=sh.block_specs_for(full, pspecs, SIZES))


def test_reduced_records_names_keys_and_bytes(fake_world):
    from repro_torch.distributed import tp_bytes
    from repro_torch.sharding import specs as sh

    res, out_dir = fake_world
    recs = res["train"]
    committed = sorted(os.listdir(os.path.join(ROOT, "experiments", "dryrun")))
    names = sorted(os.path.basename(recs[k]["path"]) for k in ("block", "full", *VARIANTS))
    assert names == committed
    ref_keys = set(json.load(open(os.path.join(ROOT, "experiments", "dryrun", committed[0]))))
    assert ref_keys - {"lower_s", "compile_s"} == REF_KEYS
    cfg = get_config("muonbp-960m").reduced()
    full, plan = _plan(cfg)
    rows = SHAPES["train_smoke"].global_batch // 4
    held = sum(math.prod(sh.local_shape(s, p.shape, SIZES)) for p, s in zip(
        _leaves(full), _leaves(sh.param_specs(full, cfg, SIZES))))
    for key, rec in recs.items():
        if key == "cpu_full":
            continue
        assert "error" not in rec, rec.get("error")
        assert REF_KEYS | {"rank", "device", "build_s", "step_s"} <= set(rec)
        assert rec["mesh"] == "2x2x2" and rec["mesh_axes"] == ["pod", "data", "model"]
        by_class = rec["collectives_by_class"]
        assert by_class["tp"] == tp_bytes(cfg, rows, 128, SIZES)
        assert by_class["grad_reduce"] == 4 * (held + 3)
        assert rec["collective_bytes_total"] == sum(by_class.values()) == sum(
            r["bytes"] for r in rec["collectives"].values())
        assert rec["calibrated"]["samples"] is None and rec["calibrated"]["reason"]
        assert rec["cost"]["bytes accessed"] is None and rec["cost"]["transcendentals"] is None
        assert rec["memory"]["argument_bytes"] > 0 and rec["memory"]["peak_bytes"] > 0
    assert plan.predicted_bytes("block") == 0
    assert not {"block", "full", "apply"} & set(recs["block"]["collectives_by_class"])
    for key in ("full", "normuon", "turbo_muon"):
        assert recs[key]["collectives_by_class"]["full"] == plan.predicted_bytes("full") > 0
    # Dion moves its factor products, none of the plan's gathers.
    assert recs["dion"]["collectives_by_class"]["dion"] > 0
    assert "full" not in recs["dion"]["collectives_by_class"]
    # Turbo-Muon's chain is two steps shorter.
    assert {c.rsplit("=", 1)[1] for c in recs["turbo_muon"]["cost"]["ns_chains"]} == {"3"}
    assert recs["full"]["cost"]["ns_chain_flops"] > recs["block"]["cost"]["ns_chain_flops"] > 0
    # The records on disk are the ones returned.
    disk = json.load(open(recs["full"]["path"]))
    assert disk["collectives"] == recs["full"]["collectives"]


def _leaves(tree):
    from repro_torch import tree as tree_lib

    return tree_lib.leaves(tree)


def test_fake_and_cpu_agree(fake_world):
    res, _ = fake_world
    fake, cpu = res["train"]["full"], res["train"]["cpu_full"]
    assert cpu["device"] == "cpu" and fake["device"] == "fake"
    assert cpu["collectives"] == fake["collectives"]
    assert cpu["collectives_by_class"] == fake["collectives_by_class"]
    for key in ("flops", "counted_flops", "ns_chain_flops", "ns_chains"):
        assert cpu["cost"][key] == fake["cost"][key], key
    assert cpu["memory"]["argument_bytes"] == fake["memory"]["argument_bytes"]


def test_prefill_and_decode_cache_and_tp_bytes(fake_world):
    from repro_torch.distributed import tp_bytes
    from repro_torch.sharding import specs as sh

    res, _ = fake_world
    for name, (arch, kind, seq, batch, variant) in SERVE.items():
        rec = res["serve"][name]
        cfg = get_config(arch).reduced()
        rows = batch // 4
        kv = bool(variant.get("kv_seq_shard"))
        cache_len = rec["cache_len"]
        kw = dict(batch=batch, kv_seq_shard=kv, compute_bytes=2)
        if kind == "prefill":
            want = tp_bytes(cfg, rows, seq, SIZES, mode="prefill", cache_len=cache_len, **kw)
        else:
            want = tp_bytes(cfg, rows, cache_len, SIZES, mode="decode", **kw)
            assert rec["cache_bytes"] == sh.cache_bytes(sh.local_cache_shapes(
                cfg, batch, cache_len, SIZES, kv_seq_shard=kv), 2)
            assert rec["decode_pos"] == seq - 1
        assert rec["collectives_by_class"] == {"tp": want}, name
        assert want > 0


def test_production_mesh_and_perf_record(fake_world):
    res, out_dir = fake_world
    assert res["production"] == {"False": {"data": 16, "model": 16},
                                 "True": {"pod": 2, "data": 16, "model": 16}}
    assert "needs 256 ranks" in res["mesh_mismatch"]
    rec = json.load(open(os.path.join(out_dir, "ls.json")))
    assert rec["perf_name"] == "ls" and rec["variant"]["layer_shard"] is True
    _, plan = _plan(get_config("muonbp-960m").reduced())
    fold = rec["collectives_by_class"]["full"] - plan.predicted_bytes("full")
    assert fold > 0 and fold == _fold_bytes()


def _fold_bytes() -> int:
    """The fold's gathers over 'data' of the reduced model's full buckets."""
    from repro_torch.core import label_tree, program
    from repro_torch.distributed import layer_shard_collectives, make_engine
    from repro_torch.sharding import specs as sh
    from repro_torch import tree as tree_lib

    cfg = get_config("muonbp-960m").reduced()
    full = dryrun.abstract_params(cfg)
    engine = make_engine(full, sh.param_specs(full, cfg, SIZES), SIZES)
    labels = dict(tree_lib.flatten_with_path(label_tree(full)))
    specs = tuple(program.LeafSpec(key=k, shape=tuple(p.shape), dtype="float32")
                  for k, p in tree_lib.flatten_with_path(full) if labels[k] == "muon")
    prog = program.compile_program(specs, engine=engine, backend="cpu")
    return sum(b for op in prog.phase("full").ops
               for _, _, b in layer_shard_collectives(op.packed_shape, "data", 2, mode="engine"))


def test_shapes_match_reference_and_long_500k_skips():
    assert set(SHAPES) == set(J_SHAPES)
    for name in SHAPES:
        assert get_shape(name).kind == j_get_shape(name).kind
        for arch in ARCHS:
            assert shape_applies(get_config(arch), get_shape(name)) == j_shape_applies(
                j_get_config(arch), j_get_shape(name)), (arch, name)
    rec = dryrun.lower_combo("granite-8b", "long_500k", device="fake")
    assert rec == {"arch": "granite-8b", "shape": "long_500k", "skipped": True,
                   "reason": dryrun.SKIP_REASON}
    assert dryrun.result_path("a", "train_4k", True, "stagger:2", {"zero1": True, "x": 3}) \
        .endswith("a__train_4k__2x16x16__stagger2__x-3__zero1.json")
