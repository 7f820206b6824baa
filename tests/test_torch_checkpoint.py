"""The port's durable checkpoints against the reference's, and its resume.

The library cases of ``tests/test_checkpoint_durability.py`` run on the
port's ``training/checkpoint.py``. The format is the reference's letter for
letter, so snapshots cross between the packages: for every optimizer
variant's state (MuonBP, Turbo-Muon, NorMuon, Dion, each beside AdamW) the
port and the reference write the same npz key sets, ``"format": 2`` and
equal CRC32 manifests for equal arrays, and each restores the other's
snapshot to equal arrays. A port run resumed (``--resume``) from a snapshot
the reference wrote follows the reference's continued run to 1e-4 in the
loss (fp32; see ``tests/test_torch_slice.py``). Real SIGKILLs inside
``save`` (subprocesses) must leave the previous snapshot valid, and the
launcher killed mid-save resumes from it.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from repro.configs import get_config as j_get_config
from repro.core import BlockSpec2D as JBlockSpec2D
from repro.core import adamw as j_adamw
from repro.core import build_variant as j_build_variant
from repro.core import combine as j_combine
from repro.core import label_tree as j_label_tree
from repro.core import muon as j_muon
from repro.core import phase_for_step as j_phase_for_step
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models.model import init_params as j_init_params
from repro.models.transformer import ShardCtx
from repro.training import checkpoint as j_checkpoint
from repro.training import resilience as j_resilience
from repro.training.train_step import init_train_state as j_init_train_state
from repro.training.train_step import make_train_step_fns
from repro_torch import interop
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.core import adamw, build_variant, combine, label_tree, muon
from repro_torch.launch import train
from repro_torch.sharding import specs as sh
from repro_torch.training import checkpoint, faults
from repro_torch.training.checkpoint import CheckpointError

ROOT = Path(__file__).resolve().parents[1]
LR, ADAM_LR, WD, PERIOD, MODEL, BATCH, SEQ = 0.02, 0.008, 0.1, 5, 4, 2, 32
VARIANTS = ("muon", "turbo_muon", "normuon", "dion")


def _params():
    return {"w": np.arange(64, dtype=np.float32).reshape(8, 8), "b": np.ones(8, np.float32)}


def _env():
    # The port's processes on one intra-op thread, as this one (torch_cpu).
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    for name in ("REPRO_KILL_IN_SAVE", "REPRO_KILL_MID_SAVE"):
        env.pop(name, None)
    return env


# ---------------------------------------------------------------------------
# Atomicity, manifest and corruption (the reference's library cases)
# ---------------------------------------------------------------------------

def test_save_is_atomic_and_checksummed(tmp_path):
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, _params(), step=3, extra={"run": {"arch": "x"}})
    meta = checkpoint.load_meta(path)
    assert meta["step"] == 3 and meta["format"] == 2
    assert set(meta["checksums"]) == {"params/w", "params/b"}
    checkpoint.save(path, _params(), step=4)
    assert checkpoint.load_meta(path)["step"] == 4
    assert [n for n in os.listdir(tmp_path) if ".tmp." in n or ".old." in n] == []
    checkpoint.verify(path)


@pytest.mark.parametrize("damage", ["bitflip", "truncate"])
def test_verify_rejects_disk_damage(tmp_path, damage):
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, _params(), step=0)
    npz = os.path.join(path, "params.npz")
    if damage == "bitflip":
        faults.bitflip_file(npz, seed=1)
    else:
        faults.truncate_file(npz, keep_fraction=0.5)
    with pytest.raises(CheckpointError, match="CRC32 mismatch|unreadable|manifest"):
        checkpoint.verify(path)
    with pytest.raises(CheckpointError):
        checkpoint.restore(path, _params())


def test_verify_rejects_missing_array_file(tmp_path):
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, _params(), opt_state={"m": np.zeros(4, np.float32)}, step=0)
    os.remove(os.path.join(path, "opt_state.npz"))
    with pytest.raises(CheckpointError, match="opt_state.npz missing"):
        checkpoint.verify(path)


def test_corrupt_meta_rejected(tmp_path):
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, _params(), step=0)
    with open(os.path.join(path, "meta.json"), "w") as f:
        f.write("{not json")
    with pytest.raises(CheckpointError, match="unreadable meta.json"):
        checkpoint.load_meta(path)


def test_legacy_snapshot_without_manifest_still_loads(tmp_path):
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, _params(), step=5)
    meta = checkpoint.load_meta(path)
    del meta["checksums"]
    meta["format"] = 1
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    checkpoint.verify(path)
    p, _, step = checkpoint.restore(path, _params())
    assert step == 5
    np.testing.assert_array_equal(p["w"], _params()["w"])


def test_key_mismatch_error_names_both_sides(tmp_path):
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, _params(), step=0)
    template = {"w": np.zeros((8, 8), np.float32), "b_renamed": np.zeros(8, np.float32)}
    with pytest.raises(CheckpointError) as ei:
        checkpoint.restore(path, template)
    msg = str(ei.value)
    assert "missing from checkpoint" in msg and "b_renamed" in msg
    assert "unexpected in checkpoint" in msg and "'b'" in msg


def test_shape_mismatch_raises(tmp_path):
    checkpoint.save(str(tmp_path), {"w": torch.zeros(4, 4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(str(tmp_path), {"w": torch.zeros(4, 4, 1)})


def test_run_meta_mismatch_names_fields(tmp_path):
    path = str(tmp_path / "ckpt")
    run = {"arch": "granite-8b", "optimizer": "muonbp", "period": 5}
    checkpoint.save(path, _params(), step=0, extra={"run": run})
    checkpoint.verify(path, expect_run=run)
    checkpoint.verify(path, expect_run={"arch": "granite-8b", "zero1": True})
    with pytest.raises(CheckpointError, match="period.*snapshot=5.*run=7"):
        checkpoint.verify(path, expect_run={"arch": "granite-8b", "period": 7})
    with pytest.raises(CheckpointError, match="arch"):
        checkpoint.restore(path, _params(), expect_run={"arch": "qwen3-4b"})


# ---------------------------------------------------------------------------
# Snapshot roots: retention and the newest-valid fallback chain
# ---------------------------------------------------------------------------

def test_retention_keeps_last_k(tmp_path):
    for step in (0, 2, 4, 6, 8):
        checkpoint.save_snapshot(str(tmp_path), _params(), step=step, keep=3)
    assert [s for s, _ in checkpoint.list_snapshots(str(tmp_path))] == [4, 6, 8]


def test_prune_removes_stale_tmp_dirs(tmp_path):
    root = str(tmp_path)
    checkpoint.save_snapshot(root, _params(), step=0)
    os.makedirs(os.path.join(root, "step_00000002.tmp.abc123"))
    os.makedirs(os.path.join(root, "step_00000000.old.xyz"))
    assert len(checkpoint.prune_snapshots(root, keep=5)) == 2
    assert os.listdir(root) == ["step_00000000"]


def test_latest_valid_skips_corrupt_newest(tmp_path):
    root = str(tmp_path)
    for step in (1, 3, 5):
        checkpoint.save_snapshot(root, _params(), step=step)
    faults.bitflip_file(os.path.join(checkpoint.snapshot_path(root, 5), "params.npz"), seed=0)
    skipped = []
    path, meta = checkpoint.latest_valid(root, on_skip=lambda p, r: skipped.append((p, r)))
    assert meta["step"] == 3 and path.endswith("step_00000003")
    assert len(skipped) == 1 and skipped[0][0].endswith("step_00000005")


def test_latest_valid_none_when_empty_or_all_bad(tmp_path):
    assert checkpoint.latest_valid(str(tmp_path / "nothing")) is None
    root = str(tmp_path)
    checkpoint.save_snapshot(root, _params(), step=0)
    faults.truncate_file(os.path.join(checkpoint.snapshot_path(root, 0), "params.npz"))
    assert checkpoint.latest_valid(root) is None


def test_latest_valid_skips_wrong_run(tmp_path):
    root = str(tmp_path)
    checkpoint.save_snapshot(root, _params(), step=0, extra={"run": {"arch": "a"}})
    checkpoint.save_snapshot(root, _params(), step=2, extra={"run": {"arch": "b"}})
    _, meta = checkpoint.latest_valid(root, expect_run={"arch": "a"})
    assert meta["step"] == 0


# ---------------------------------------------------------------------------
# The format against the reference's, for every variant's state
# ---------------------------------------------------------------------------

def _state_case(variant):
    """The reduced muonbp-960m and one updated state of ``variant`` beside
    AdamW, in both packages (the port's carried over from the reference's)."""
    jcfg = j_get_config("muonbp-960m").reduced()
    params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg))
    grads = jax.tree.map(lambda p: 0.01 * np.sign(p) + 1e-3, params)
    if variant == "dion":
        r_matrix, p_matrix = (j_build_variant("dion", LR, rank=8),
                              build_variant("dion", LR, rank=8))
    else:
        r_matrix, p_matrix = (j_muon(LR, period=PERIOD, variant=variant),
                              muon(LR, period=PERIOD, variant=variant))
    ref = j_combine({"muon": r_matrix, "adamw": j_adamw(ADAM_LR)}, j_label_tree(params))
    _, r_state = ref.update(grads, ref.init(params), params, "full")
    p_params = interop.params_from_numpy(params, device="cpu")
    port = combine({"muon": p_matrix, "adamw": adamw(ADAM_LR)}, label_tree(p_params))
    p_state = interop.combined_state_from_numpy(
        {k: jax.tree.map(np.asarray, s._asdict()) for k, s in r_state.inner.items()},
        device="cpu")
    return params, ref, r_state, p_params, port, p_state


def _npz(path, name):
    with np.load(os.path.join(path, name)) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("variant", VARIANTS)
def test_snapshots_cross_between_the_packages(tmp_path, variant):
    params, ref, r_state, p_params, port, p_state = _state_case(variant)
    r_path, p_path = str(tmp_path / "ref"), str(tmp_path / "port")
    j_checkpoint.save(r_path, params, r_state, step=7, extra={"run": {"arch": "a"}})
    checkpoint.save(p_path, p_params, p_state, step=7, extra={"run": {"arch": "a"}})

    # The same files, keys, format and manifest, array for array.
    r_meta, p_meta = checkpoint.load_meta(r_path), checkpoint.load_meta(p_path)
    assert r_meta == p_meta and p_meta["format"] == 2
    for name in ("params.npz", "opt_state.npz"):
        r_arrays, p_arrays = _npz(r_path, name), _npz(p_path, name)
        assert list(p_arrays) == list(r_arrays)
        for k, want in r_arrays.items():
            assert p_arrays[k].dtype == want.dtype and np.array_equal(p_arrays[k], want), k
    assert len(_npz(p_path, "opt_state.npz")) == len(checkpoint._flatten(p_state))

    # The reference restores the port's snapshot...
    r_params, r_opt, step = j_checkpoint.restore(p_path, params, ref.init(params))
    assert step == 7
    for a, b in zip(jax.tree.leaves(r_state), jax.tree.leaves(r_opt)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # ...and the port the reference's, into its own state types.
    got_p, got_o, step = checkpoint.restore(r_path, p_params, port.init(p_params),
                                            device="cpu")
    assert step == 7
    assert checkpoint._flatten(got_p).keys() == checkpoint._flatten(p_params).keys()
    for path, t in tree_lib.flatten_with_path(got_p):
        assert torch.equal(t, dict(tree_lib.flatten_with_path(p_params))[path])
    want, got = checkpoint._flatten(p_state), checkpoint._flatten(got_o)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert type(got_o.inner["muon"]) is type(p_state.inner["muon"])
    assert isinstance(got_o.inner["adamw"].count, int)
    # interop carries the combined state back to the reference's fields.
    back = interop.combined_state_to_numpy(got_o)
    for label, sub in r_state.inner.items():
        for field, tree in sub._asdict().items():
            want_leaves = jax.tree.leaves(tree)
            got_leaves = jax.tree.leaves(back[label][field])
            assert len(got_leaves) == len(want_leaves), (label, field)
            for g, w in zip(got_leaves, want_leaves):
                assert np.array_equal(np.asarray(g), np.asarray(w)), (label, field)


def test_normuon_state_restores_bitwise_with_host_counters(tmp_path):
    _, _, _, p_params, port, p_state = _state_case("normuon")
    root = str(tmp_path / "snaps")
    checkpoint.save_snapshot(root, p_params, p_state, step=7)
    path, meta = checkpoint.latest_valid(root)
    _, restored, step = checkpoint.restore(path, p_params, port.init(p_params))
    muon_state = restored.inner["muon"]
    assert step == 7 and set(muon_state.vcount.values()) == {1}
    assert all(isinstance(c, int) for c in muon_state.vcount.values())
    for path_, v in p_state.inner["muon"].second_moment.items():
        assert torch.equal(v, muon_state.second_moment[path_])
    # A baseline state has no variant leaves, and restores as such.
    base = muon(LR, period=PERIOD)
    only_muon = tree_lib.tree_map(lambda p, l: p if l == "muon" else None, p_params,
                                  label_tree(p_params))
    b_state = base.init(only_muon)
    checkpoint.save_snapshot(root, only_muon, b_state, step=8)
    _, r2, _ = checkpoint.restore(checkpoint.latest_valid(root)[0], only_muon, b_state)
    assert r2.second_moment is None and r2.vcount is None


# ---------------------------------------------------------------------------
# Resume across packages
# ---------------------------------------------------------------------------

def test_port_resumes_a_reference_snapshot_and_follows_the_reference(tmp_path):
    """The reference trains 3 guarded steps, writes a snapshot as its
    launcher does (run metadata, data-stream position, guard counters) and
    goes on for 3 more; the port's launcher resumes from that snapshot and
    runs the same 3 steps."""
    jcfg = j_get_config("muonbp-960m").reduced()
    params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg))
    p_params = interop.params_from_numpy(params, device="cpu")
    sizes = {"model": MODEL}
    bspecs = sh.block_specs_for(p_params, sh.param_specs(p_params, get_config(
        "muonbp-960m").reduced(), sizes), sizes)
    labels = label_tree(p_params)
    j_bspecs = tree_lib.tree_map(lambda b, l: JBlockSpec2D(b.r, b.c) if l == "muon" else None,
                                 bspecs, labels)
    opt = j_combine({"muon": j_muon(LR, LR, period=PERIOD, weight_decay=WD, block_specs=j_bspecs),
                     "adamw": j_adamw(ADAM_LR, weight_decay=WD)}, j_label_tree(params))
    gcfg = j_resilience.GuardConfig()
    fns = make_train_step_fns(jcfg, opt, ShardCtx(), donate=False, compute_dtype=jnp.float32,
                              guard=gcfg)
    state = j_init_train_state(jax.tree.map(jnp.asarray, params), opt, guard=True)
    pipe_src = JSyntheticLM(jcfg, BATCH, SEQ, seed=0)
    pipe = iter(pipe_src)
    root = str(tmp_path / "ckpt")
    run_meta = {"arch": jcfg.name, "optimizer": "muonbp", "variant": "muon", "period": PERIOD,
                "mesh": {"data": 1, "model": MODEL}, "zero1": False, "seed": 0,
                "schedule": {"mode": "synchronous", "period": PERIOD, "offsets": None}}
    losses = []
    for t in range(6):
        batch = {k: jnp.asarray(v) for k, v in next(pipe).items()}
        state, m = fns[j_phase_for_step(t, PERIOD)](state, batch)
        losses.append(float(m["loss"]))
        if t == 2:
            j_checkpoint.save_snapshot(root, state.params, state.opt_state, step=t, extra={
                "run": run_meta, "data_state": pipe_src.state(),
                "guard": j_resilience.guard_to_meta(state.guard)})
    argv = ["--reduced", "--mesh-model", str(MODEL), "--steps", "6", "--batch", str(BATCH),
            "--seq", str(SEQ), "--period", str(PERIOD), "--lr", str(LR), "--adam-lr",
            str(ADAM_LR), "--schedule", "const", "--compute-dtype", "float32", "--device",
            "cpu", "--guard", "--resume", "--checkpoint-dir", root]
    run = train.run(argv)
    assert [r["step"] for r in run.records] == [3, 4, 5]
    np.testing.assert_allclose([r["loss"] for r in run.records], losses[3:], rtol=0, atol=1e-4)
    assert int(run.state.guard.ema_count) == 6 and run.counters["resumes"] == 1


# ---------------------------------------------------------------------------
# SIGKILL inside save, and the launcher killed mid-save (subprocesses)
# ---------------------------------------------------------------------------

_KILL_SCRIPT = textwrap.dedent("""
    import torch
    from repro_torch.training import checkpoint
    params = {{"w": torch.arange(64, dtype=torch.float32)}}
    checkpoint.save_snapshot({root!r}, params, step=0)   # survives
    checkpoint.save_snapshot({root!r}, params, step=2)   # killed via env
    print("UNREACHABLE")
""")


@pytest.mark.parametrize("env_var", ["REPRO_KILL_IN_SAVE", "REPRO_KILL_MID_SAVE"])
def test_sigkill_during_save_leaves_previous_snapshot_valid(tmp_path, env_var):
    root = str(tmp_path / "snaps")
    env = {**_env(), env_var: "1"}
    proc = subprocess.run([sys.executable, "-c", _KILL_SCRIPT.format(root=root)],
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == -signal.SIGKILL, (proc.returncode, proc.stderr[-2000:])
    assert "UNREACHABLE" not in proc.stdout
    assert [s for s, _ in checkpoint.list_snapshots(root)] == [0]
    assert any(".tmp." in n for n in os.listdir(root))
    path, meta = checkpoint.latest_valid(root)
    assert meta["step"] == 0
    checkpoint.save_snapshot(root, {"w": torch.zeros(64)}, step=4, keep=3)
    assert not any(".tmp." in n for n in os.listdir(root))


def test_launcher_killed_in_save_resumes_from_the_last_snapshot(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--steps", "6",
            "--batch", "2", "--seq", "32", "--period", "3", "--mesh-model", "2", "--guard",
            "--log-every", "1", "--checkpoint-every", "2", "--checkpoint-dir", ckpt,
            "--keep-checkpoints", "2", "--device", "cpu"]
    first = subprocess.run(base + ["--fault-plan", "kill_in_save@3"], capture_output=True,
                           text=True, env=_env(), timeout=300)
    assert first.returncode == -signal.SIGKILL, (first.returncode, first.stderr[-2000:])
    second = subprocess.run(base + ["--resume"], capture_output=True, text=True, env=_env(),
                            timeout=300)
    assert second.returncode == 0, second.stderr[-4000:]
    recs = [json.loads(l) for l in second.stdout.splitlines() if l.startswith("{")]
    resume = next(r for r in recs if r.get("event") == "resume")
    assert resume["step"] == 3 and resume["snapshot"].endswith("step_00000002")
    steps = [r["step"] for r in recs if "loss" in r]
    assert steps == [3, 4, 5]
    path, meta = checkpoint.latest_valid(ckpt)
    assert meta["step"] == 5 and meta["run"]["arch"] == "muonbp-960m"
    # Both launches' step lines: the resumed run replays steps 3-5 on the
    # same data as the killed one.
    killed = {r["step"]: r["loss"] for r in (json.loads(l) for l in first.stdout.splitlines()
                                              if l.startswith("{")) if "loss" in r}
    assert all(killed[s] == r["loss"] for s, r in
               ((r["step"], r) for r in recs if "loss" in r) if s in killed)


def test_launcher_resume_starts_fresh_or_falls_back_past_a_corrupt_snapshot(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    argv = ["--reduced", "--batch", "1", "--seq", "8", "--period", "2", "--device", "cpu",
            "--checkpoint-every", "1", "--checkpoint-dir", ckpt, "--resume", "--log-every", "1"]
    first = train.run(argv + ["--steps", "3"])  # nothing to resume: a fresh start
    assert [r["step"] for r in first.records] == [0, 1, 2]
    assert [s for s, _ in checkpoint.list_snapshots(ckpt)] == [1, 2]  # never at step 0
    faults.bitflip_file(os.path.join(checkpoint.snapshot_path(ckpt, 2), "opt_state.npz"))
    capsys.readouterr()
    second = train.run(argv + ["--steps", "4"])
    events = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    skips = [e for e in events if e.get("event") == "skip_snapshot"]
    assert len(skips) == 1 and skips[0]["path"].endswith("step_00000002")
    resume = next(e for e in events if e.get("event") == "resume")
    assert resume["step"] == 2 and resume["snapshot"].endswith("step_00000001")
    assert [r["step"] for r in second.records] == [2, 3]
    # The replayed step 2 sees the same batch and state as the first run's.
    assert second.records[0]["loss"] == first.records[2]["loss"]
    assert second.counters["checkpoint.fallbacks"] == 1 and second.counters["resumes"] == 1
