"""Training of the port's MoE models against the JAX package (reduced
``olmoe-1b-7b`` and ``mixtral-8x7b``): one MuonBP step a phase on the
launcher's 4-way grid, gradient accumulation's metrics, the interop of
parameters and optimizer state, and the launcher with its aux metrics.

The setup, the reference's jitted calls and the tolerances are
``tests/test_torch_moe_model.py``'s: metrics to 1e-4, Muon-updated weights
to 1e-5, AdamW's to 1e-4.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from repro.core import BlockSpec2D as JBlockSpec2D
from repro.core import adamw as j_adamw
from repro.core import combine as j_combine
from repro.core import label_tree as j_label_tree
from repro.core import muon as j_muon
from repro.training.train_step import init_train_state as j_init_train_state
from repro.training.train_step import train_step as j_train_step
from repro_torch import interop
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.core import adamw, combine, label_tree, muon
from repro_torch.launch import train
from repro_torch.obs.bus import read_jsonl
from repro_torch.training.train_step import init_train_state, train_step

from test_torch_moe_model import (
    ADAM_LR,
    ARCHS,
    LR,
    MODEL,
    PERIOD,
    TOL,
    _batch,
    _jit,
    _models,
    _t,
    _tokens,
)


# ---------------------------------------------------------------------------
# Training: one MuonBP step a phase, accumulation, interop, the launcher
# ---------------------------------------------------------------------------

def _optimizers(jparams, params, block_specs):
    j_bspecs = tree_lib.tree_map(lambda b: JBlockSpec2D(b.r, b.c), block_specs)
    j_opt = j_combine({"muon": j_muon(LR, period=PERIOD, block_specs=j_bspecs),
                       "adamw": j_adamw(ADAM_LR)}, j_label_tree(jparams))
    opt = combine({"muon": muon(LR, period=PERIOD, block_specs=block_specs),
                   "adamw": adamw(ADAM_LR)}, label_tree(params))
    return j_opt, opt


def _assert_params_close(port_params, ref_params, params):
    new = dict(tree_lib.flatten_with_path(interop.params_to_numpy(port_params)))
    labels = dict(tree_lib.flatten_with_path(label_tree(params)))
    for path, ref in tree_lib.flatten_with_path(jax.tree.map(np.asarray, ref_params)):
        atol = 1e-5 if labels[path] == "muon" else 1e-4
        np.testing.assert_allclose(new[path], ref, rtol=0, atol=atol, err_msg=str(path))


def _step_inputs(name):
    jcfg, jparams, cfg, params = _models(name)
    block_specs = train.matrix_block_specs(params, cfg, MODEL)
    batch = _batch(_tokens(cfg, seed=6, shape=(4, 16)))
    return jcfg, jparams, cfg, params, block_specs, batch


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("phase", ["full", "block"])
def test_one_muonbp_step_matches_reference(name, phase):
    """One fp32 step in each phase on the launcher's 4-way grid: metrics and
    every updated weight against the reference's train_step (ShardCtx())."""
    jcfg, jparams, cfg, params, block_specs, batch = _step_inputs(name)
    grid = block_specs["layers"]["moe"]["wi"]
    assert (grid.r, grid.c) == (1, MODEL)
    j_opt, opt = _optimizers(jparams, params, block_specs)
    j_state, j_metrics = _jit(
        j_train_step, j_init_train_state(jparams, j_opt),
        {k: jnp.asarray(v) for k, v in batch.items()}, cfg=jcfg, optimizer=j_opt, phase=phase,
        compute_dtype=jnp.float32)
    state, metrics = train_step(
        init_train_state(params, opt), {k: _t(v) for k, v in batch.items()}, cfg=cfg,
        optimizer=opt, phase=phase, compute_dtype=torch.float32)
    for k in ("ce", "load_balance", "z_loss", "loss"):
        assert abs(float(metrics[k]) - float(j_metrics[k])) <= TOL, k
    assert float(metrics["grad_norm"]) == pytest.approx(float(j_metrics["grad_norm"]), rel=1e-4)
    _assert_params_close(state.params, j_state.params, params)


@pytest.mark.parametrize("name", ARCHS)
def test_accumulation_averages_every_metric_as_the_reference(name):
    """accum_steps = 2: every metric is the mean over the microbatches. The
    MoE loss is not its CE, so a metric tree of {ce: loss, loss: loss}
    fails here."""
    jcfg, jparams, cfg, params, block_specs, batch = _step_inputs(name)
    j_opt, opt = _optimizers(jparams, params, block_specs)
    j_state, j_metrics = _jit(
        j_train_step, j_init_train_state(jparams, j_opt),
        {k: jnp.asarray(v) for k, v in batch.items()}, cfg=jcfg, optimizer=j_opt, phase="full",
        compute_dtype=jnp.float32, accum_steps=2)
    state, metrics = train_step(
        init_train_state(params, opt), {k: _t(v) for k, v in batch.items()}, cfg=cfg,
        optimizer=opt, phase="full", compute_dtype=torch.float32, accum_steps=2)
    assert set(metrics) == set(j_metrics)
    for k in ("ce", "load_balance", "z_loss", "loss"):
        assert abs(float(metrics[k]) - float(j_metrics[k])) <= TOL, k
    assert float(metrics["ce"]) != float(metrics["loss"])
    _assert_params_close(state.params, j_state.params, params)


def test_interop_carries_moe_params_and_optimizer_state():
    """Parameters round-trip exactly; the reference's optimizer state after a
    full step, carried over, gives the port's next (block) step the
    reference's next step."""
    name = "olmoe-1b-7b"
    jcfg, jparams, cfg, params, block_specs, batch = _step_inputs(name)
    back = interop.params_to_numpy(params)
    for path, ref in tree_lib.flatten_with_path(jax.tree.map(np.asarray, jparams)):
        np.testing.assert_array_equal(dict(tree_lib.flatten_with_path(back))[path], ref)
    j_opt, opt = _optimizers(jparams, params, block_specs)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    j_state, _ = _jit(j_train_step, j_init_train_state(jparams, j_opt), jbatch, cfg=jcfg,
                      optimizer=j_opt, phase="full", compute_dtype=jnp.float32)
    inner = {label: jax.tree.map(np.asarray, sub._asdict())
             for label, sub in j_state.opt_state.inner.items()}
    carried = interop.combined_state_from_numpy(inner, device="cpu")
    momentum = carried.inner["muon"].momentum
    assert momentum[("layers", "moe", "wi")].shape == (cfg.num_layers, cfg.num_experts,
                                                       cfg.d_model, cfg.d_ff)
    j_state2, _ = _jit(j_train_step, j_state, jbatch, cfg=jcfg, optimizer=j_opt, phase="block",
                       compute_dtype=jnp.float32)
    state = init_train_state(interop.params_from_numpy(jax.tree.map(np.asarray, j_state.params),
                                                       device="cpu"), opt)
    state = state._replace(opt_state=carried, step=1)
    state2, _ = train_step(state, {k: _t(v) for k, v in batch.items()}, cfg=cfg, optimizer=opt,
                           phase="block", compute_dtype=torch.float32)
    _assert_params_close(state2.params, j_state2.params, params)
    again = interop.combined_state_to_numpy(carried)
    np.testing.assert_array_equal(again["muon"]["momentum"]["layers"]["moe"]["router"],
                                  inner["muon"]["momentum"]["layers"]["moe"]["router"])


@pytest.mark.parametrize("name", ARCHS)
def test_launcher_runs_moe_archs_and_records_aux(name, tmp_path, capsys):
    log = tmp_path / "run.jsonl"
    argv = ["--arch", name, "--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
            "--seq", "16", "--period", "2", "--mesh-model", "4", "--log-every", "1",
            "--log-file", str(log)]
    run = train.run(argv)
    assert [r["phase"] for r in run.records] == ["full", "block", "full"]
    for r in run.records:
        assert np.isfinite([r["loss"], r["load_balance"], r["z_loss"]]).all()
        assert r["load_balance"] > 0 and r["z_loss"] > 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    steps = [l for l in lines if "loss" in l and "event" not in l]
    assert [round(r["load_balance"], 6) for r in run.records] == [l["load_balance"] for l in steps]
    end = [r for r in read_jsonl(str(log)) if r.get("event") == "run_end"]
    assert end[0]["load_balance"] == run.records[-1]["load_balance"]
    assert end[0]["z_loss"] == run.records[-1]["z_loss"]
    # A cut in depth through cfg=, which the reference has no flag for.
    shallow = dataclasses.replace(get_config(name).reduced(), num_layers=1)
    one = train.run(argv[:-2] + ["--steps", "1"], cfg=shallow)
    assert one.state.params["layers"]["moe"]["wi"].shape[0] == 1
