"""The port's training slice as a whole against the JAX package, and its isolation.

Six MuonBP steps (phases full, block x4, full) of the reduced muonbp-960m
with a 4-way block grid, in both packages, from the reference's initial
parameters and the same ``SyntheticLM`` batches. The port runs its
launcher's own loop on the CPU; the reference runs the mesh-free loop of
``tests/test_system.py`` with ``muon(..., block_specs=...)`` and ``adamw``
through ``combine``.

Tolerances on the per-step loss: 1e-4 in fp32 compute. Both sides differ
only in summation order, but the NS chain amplifies the relative error of
a gradient's smallest singular directions (each step multiplies by up to
a = 2), and six updates feed back into the loss. 2e-2 in bf16 compute,
where the two frameworks round activations at other places (8 mantissa
bits, a relative 4e-3 a rounding).
"""

import json
import os
import shutil
import subprocess
import sys
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
from repro.core import combine as j_combine
from repro.core import label_tree as j_label_tree
from repro.core import muon as j_muon
from repro.core import phase_for_step as j_phase_for_step
from repro.core import schedule as j_schedule
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models.model import init_params as j_init_params
from repro.models.transformer import ShardCtx
from repro.training.train_step import init_train_state as j_init_train_state
from repro.training.train_step import make_train_step_fns
from repro_torch import interop
from repro_torch import tree as tree_lib
from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]
STEPS, PERIOD, MODEL, BATCH, SEQ = 6, 5, 4, 2, 32
LR, ADAM_LR, WD = 0.02, 0.008, 0.1


def _reference_params():
    jcfg = j_get_config("muonbp-960m").reduced()
    return jcfg, jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg))


def _reference_losses(jcfg, params, compute_dtype, block_specs):
    j_bspecs = tree_lib.tree_map(lambda b: JBlockSpec2D(b.r, b.c), block_specs)
    lr, adam_lr = j_schedule.wsd(LR, STEPS), j_schedule.wsd(ADAM_LR, STEPS)
    opt = j_combine({"muon": j_muon(lr, lr, period=PERIOD, weight_decay=WD, block_specs=j_bspecs),
                     "adamw": j_adamw(adam_lr, weight_decay=WD)}, j_label_tree(params))
    state = j_init_train_state(jax.tree.map(jnp.asarray, params), opt)
    fns = make_train_step_fns(jcfg, opt, ShardCtx(), donate=False, compute_dtype=compute_dtype)
    pipe = iter(JSyntheticLM(jcfg, BATCH, SEQ, seed=0))
    losses, phases = [], []
    for t in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in next(pipe).items()}
        phase = j_phase_for_step(t, PERIOD)
        state, metrics = fns[phase](state, batch)
        losses.append(float(metrics["loss"]))
        phases.append(phase)
    return losses, phases


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_six_muonbp_steps_track_the_reference(compute_dtype, tol):
    jcfg, params = _reference_params()
    argv = ["--arch", "muonbp-960m", "--reduced", "--optimizer", "muonbp",
            "--period", str(PERIOD), "--mesh-model", str(MODEL), "--steps", str(STEPS),
            "--batch", str(BATCH), "--seq", str(SEQ), "--lr", str(LR),
            "--adam-lr", str(ADAM_LR), "--compute-dtype", compute_dtype, "--device", "cpu"]
    run = train.run(argv, params=interop.params_from_numpy(params, device="cpu"))
    port_losses = [r["loss"] for r in run.records]
    port_phases = [r["phase"] for r in run.records]
    assert port_phases == ["full", "block", "block", "block", "block", "full"]

    ref_losses, ref_phases = _reference_losses(
        jcfg, params, getattr(jnp, compute_dtype), run.block_specs)
    assert port_phases == ref_phases
    np.testing.assert_allclose(port_losses, ref_losses, rtol=0, atol=tol)
    assert np.isfinite(port_losses).all()
    # The run's block grid is the declared 4-way one: column blocks on wq.
    grid = run.block_specs["layers"]["attn"]["wq"]
    assert (grid.r, grid.c) == (1, MODEL)


def test_launcher_prints_one_line_per_step(capsys):
    train.main(["--reduced", "--steps", "2", "--batch", "1", "--seq", "8", "--period", "2",
                "--mesh-model", "2", "--device", "cpu"])
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert [json.loads(l)["phase"] for l in lines] == ["full", "block"]


def test_launcher_without_device_cpu_refuses_a_machine_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run(["--reduced", "--steps", "1", "--batch", "1", "--seq", "8"])


def test_port_imports_no_jax_and_no_reference_module():
    """Every module of the port, and chip_smoke.py, imported in a fresh process."""
    code = (
        "import importlib, pkgutil, runpy, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n in ('jax', 'repro') or n.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


def test_chip_smoke_refuses_to_run_without_a_card_or_the_repo(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, timeout=120, cwd=ROOT, env=env)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path, env=env)
    assert out.returncode != 0 and '"ok"' not in out.stdout


@pytest.mark.parametrize("mode", ["accum_steps", "bf16_grads"])
def test_train_step_options_match_reference(mode):
    """One full-phase step with gradient accumulation or bf16 gradients."""
    from repro.training.train_step import train_step as j_train_step
    from repro_torch.configs import get_config
    from repro_torch.core import adamw, combine, label_tree, muon
    from repro_torch.training.train_step import init_train_state, train_step

    jcfg, params = _reference_params()
    batch = next(iter(JSyntheticLM(jcfg, 4, 16, seed=2)))
    kw = {"accum_steps": 2} if mode == "accum_steps" else {"bf16_grads": True}
    dtype = "float32" if mode == "accum_steps" else "bfloat16"
    j_opt = j_combine({"muon": j_muon(LR, period=PERIOD), "adamw": j_adamw(ADAM_LR)},
                      j_label_tree(params))
    j_state, j_metrics = j_train_step(
        j_init_train_state(jax.tree.map(jnp.asarray, params), j_opt),
        {k: jnp.asarray(v) for k, v in batch.items()}, cfg=jcfg, optimizer=j_opt,
        phase="full", compute_dtype=getattr(jnp, dtype), **kw)
    p_params = interop.params_from_numpy(params, device="cpu")
    opt = combine({"muon": muon(LR, period=PERIOD), "adamw": adamw(ADAM_LR)}, label_tree(p_params))
    state, metrics = train_step(
        init_train_state(p_params, opt), {k: torch.from_numpy(v).long() for k, v in batch.items()},
        cfg=get_config("muonbp-960m").reduced(), optimizer=opt, phase="full",
        compute_dtype=getattr(torch, dtype), **kw)
    # fp32 accumulation: the loss and the Muon-updated weights to 1e-5 (the
    # update is O(lr)). AdamW's first step is -lr g / (|g| + eps), which
    # turns a rounding difference in a gradient entry within a few eps of 0
    # into one of up to lr, so its weights get 1e-4. bf16 gradients: the
    # loss to 2e-2 (see module doc).
    tol = 1e-5 if mode == "accum_steps" else 2e-2
    assert abs(float(metrics["loss"]) - float(j_metrics["loss"])) <= tol
    if mode == "accum_steps":
        assert float(metrics["grad_norm"]) == pytest.approx(float(j_metrics["grad_norm"]), rel=1e-5)
        new = dict(tree_lib.flatten_with_path(interop.params_to_numpy(state.params)))
        labels = dict(tree_lib.flatten_with_path(label_tree(p_params)))
        for path, ref in tree_lib.flatten_with_path(jax.tree.map(np.asarray, j_state.params)):
            atol = 1e-5 if labels[path] == "muon" else 1e-4
            np.testing.assert_allclose(new[path], ref, rtol=0, atol=atol, err_msg=str(path))


@pytest.mark.parametrize("optimizer", ["muonbp", "muon", "blockmuon", "adamw"])
def test_launcher_optimizers_and_bucketing_agree(optimizer):
    """Each --optimizer runs; --no-ns-bucketing changes no loss."""
    argv = ["--reduced", "--steps", "3", "--batch", "1", "--seq", "16", "--period", "2",
            "--mesh-model", "2", "--device", "cpu", "--compute-dtype", "float32",
            "--optimizer", optimizer]
    losses = [r["loss"] for r in train.run(argv).records]
    unbucketed = [r["loss"] for r in train.run(argv + ["--no-ns-bucketing"]).records]
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses, unbucketed, rtol=0, atol=1e-5)
