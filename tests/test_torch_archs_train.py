"""Training of the port's SSM, hybrid, VLM and audio architectures against
the JAX package (reduced ``mamba2-1.3b``, ``hymba-1.5b``, ``internvl2-1b``,
``whisper-small``): one MuonBP step a phase, the synthetic stream with its
stub inputs, the launcher, a mamba2 snapshot crossed with the reference's
format, and the serving engine's refusal.

The setup, the reference's jitted calls and the tolerances are
``tests/test_torch_archs.py``'s: Muon-updated weights to 1e-5, AdamW's to
1e-4 (as ``_assert_params_close`` states), stream draws exactly.
"""

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
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models.model import init_params as j_init_params
from repro.training import checkpoint as j_checkpoint
from repro.training.train_step import init_train_state as j_init_train_state
from repro.training.train_step import train_step as j_train_step
from repro_torch import interop
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.core import adamw, combine, label_tree, muon
from repro_torch.data import SyntheticLM
from repro_torch.launch import train
from repro_torch.models.model import init_params
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.serve_step import generate
from repro_torch.training import checkpoint
from repro_torch.training.train_step import init_train_state, train_step

from test_torch_archs import (
    ADAM_LR,
    ARCHS,
    LR,
    MODEL,
    PERIOD,
    S,
    TOL,
    _batch,
    _extras,
    _j,
    _models,
    _t,
)


# ---------------------------------------------------------------------------
# Training: one MuonBP step a phase, the stream, the launcher, snapshots
# ---------------------------------------------------------------------------

def _optimizers(jparams, params, block_specs):
    j_bspecs = tree_lib.tree_map(lambda b: JBlockSpec2D(b.r, b.c), block_specs)
    j_opt = j_combine({"muon": j_muon(LR, period=PERIOD, block_specs=j_bspecs),
                       "adamw": j_adamw(ADAM_LR)}, j_label_tree(jparams))
    opt = combine({"muon": muon(LR, period=PERIOD, block_specs=block_specs),
                   "adamw": adamw(ADAM_LR)}, label_tree(params))
    return j_opt, opt


def _assert_params_close(port_params, j_state, params):
    """Muon leaves to 1e-5; AdamW leaves to 1e-4 where the reference's
    gradient is over 1e-6 (its first moment over 1e-7), and within the step's
    bound ``ADAM_LR`` where it is not: there the first step,
    -lr g / (|g| + 1e-8), turns a rounding difference of g into one of up to
    lr."""
    new = dict(tree_lib.flatten_with_path(interop.params_to_numpy(port_params)))
    labels = dict(tree_lib.flatten_with_path(label_tree(params)))
    mu = dict(tree_lib.flatten_with_path(jax.tree.map(
        np.asarray, j_state.opt_state.inner["adamw"].mu)))
    for path, ref in tree_lib.flatten_with_path(jax.tree.map(np.asarray, j_state.params)):
        if labels[path] == "muon":
            np.testing.assert_allclose(new[path], ref, rtol=0, atol=1e-5, err_msg=str(path))
            continue
        err = np.abs(new[path] - ref)
        assert err.max() <= ADAM_LR, path
        assert err[np.abs(mu[path]) > 1e-7].max(initial=0.0) <= 1e-4, path


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("phase", ["full", "block"])
def test_one_muonbp_step_matches_reference(name, phase):
    """One fp32 step in each phase on the launcher's 4-way grid: metrics and
    every updated weight against the reference's train_step (ShardCtx())."""
    jcfg, jparams, cfg, params = _models(name)
    block_specs = train.matrix_block_specs(params, cfg, MODEL)
    batch = _batch(cfg, seed=6, shape=(4, S))
    j_opt, opt = _optimizers(jparams, params, block_specs)
    j_state, j_metrics = jax.jit(lambda st, b: j_train_step(
        st, b, cfg=jcfg, optimizer=j_opt, phase=phase, compute_dtype=jnp.float32))(
        j_init_train_state(jparams, j_opt), _j(batch))
    state, metrics = train_step(init_train_state(params, opt),
                                {k: _t(v) for k, v in batch.items()}, cfg=cfg, optimizer=opt,
                                phase=phase, compute_dtype=torch.float32)
    for k in ("ce", "loss"):
        assert abs(float(metrics[k]) - float(j_metrics[k])) <= TOL, k
    assert float(metrics["grad_norm"]) == pytest.approx(float(j_metrics["grad_norm"]), rel=1e-4)
    _assert_params_close(state.params, j_state, params)


@pytest.mark.parametrize("name", ARCHS)
def test_synthetic_stream_with_extras_matches_reference(name):
    """The stream's tokens and stub inputs, drawn in the reference's order,
    equal the reference's for one seed, and so does the position after."""
    cfg, jcfg = get_config(name).reduced(), j_get_config(name).reduced()
    port, ref = SyntheticLM(cfg, 2, 16, seed=3), JSyntheticLM(jcfg, 2, 16, seed=3)
    pi, ri = iter(port), iter(ref)
    for _ in range(2):
        a, b = next(pi), next(ri)
        assert a.keys() == b.keys() == {"tokens", "labels", *_extras(cfg)}
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert port.state() == ref.state()


@pytest.mark.parametrize("name", ARCHS)
def test_launcher_runs_each_arch_on_the_cpu(name):
    argv = ["--arch", name, "--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
            "--seq", "16", "--period", "2", "--mesh-model", "4", "--log-every", "1"]
    run = train.run(argv)
    assert [r["phase"] for r in run.records] == ["full", "block", "full"]
    assert np.isfinite([r["loss"] for r in run.records]).all()
    assert sum(v for k, v in run.counters.items() if k.startswith("ns_launch.cpu.")) > 0
    if name == "whisper-small":
        assert run.state.params["encoder"]["attn"]["wq"].shape[0] == 2


def test_mamba2_snapshot_crosses_the_reference_format(tmp_path):
    """The launcher's snapshot of reduced mamba2 (with its SSM leaves and
    their AdamW / Muon state) restores in the reference's checkpoint module
    leaf for leaf, and the reference's re-save of it restores in the port."""
    root = str(tmp_path / "ckpt")
    argv = ["--arch", "mamba2-1.3b", "--reduced", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq", "16", "--period", "2", "--mesh-model", "4",
            "--checkpoint-every", "1", "--checkpoint-dir", root]
    run = train.run(argv)
    path, meta = checkpoint.latest_valid(root)
    assert meta["step"] == 1 and meta["run"]["arch"] == "mamba2-1.3b"
    jcfg = j_get_config("mamba2-1.3b").reduced()
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    j_bspecs = tree_lib.tree_map(
        lambda b: None if b is None else JBlockSpec2D(b.r, b.c), run.block_specs)
    j_opt = j_combine({"muon": j_muon(LR, LR, period=2, weight_decay=0.1, block_specs=j_bspecs),
                       "adamw": j_adamw(ADAM_LR, weight_decay=0.1)}, j_label_tree(jparams))
    r_params, r_opt, step = j_checkpoint.restore(path, jparams, j_opt.init(jparams))
    assert step == 1
    for p, leaf in tree_lib.flatten_with_path(interop.params_to_numpy(run.state.params)):
        want = dict(tree_lib.flatten_with_path(jax.tree.map(np.asarray, r_params)))[p]
        np.testing.assert_array_equal(leaf, want, err_msg=str(p))
    momentum = r_opt.inner["muon"].momentum["layers"]["ssm"]["A_log"]
    np.testing.assert_array_equal(
        np.asarray(momentum),
        run.state.opt_state.inner["muon"].momentum[("layers", "ssm", "A_log")].numpy())
    back = str(tmp_path / "back")
    j_checkpoint.save(back, r_params, r_opt, step=step, extra={"run": meta["run"]})
    got_p, got_o, got_step = checkpoint.restore(back, run.state.params, run.state.opt_state,
                                                device="cpu")
    assert got_step == 1
    for (p, a), (_, b) in zip(tree_lib.flatten_with_path(got_p),
                              tree_lib.flatten_with_path(run.state.params)):
        assert torch.equal(a, b), p
    assert all(torch.equal(a, got_o.inner["adamw"].mu[k])
               for k, a in run.state.opt_state.inner["adamw"].mu.items())


@pytest.mark.parametrize("name", ARCHS)
def test_engine_refuses_the_arch_as_the_reference(name):
    """The continuous-batching engine serves dense and MoE only; these archs
    serve through generate (reference ``serving/engine.py:158``)."""
    cfg = get_config(name).reduced()
    params = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match=repr(cfg.arch_type)):
        ServingEngine(params, cfg, EngineConfig(slots=1, block_size=8, max_model_len=32,
                                                num_blocks=4, max_prompt_len=16,
                                                max_new_tokens=8))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_entry_points_need_a_card_unless_given_the_cpu():
    cfg = get_config("mamba2-1.3b").reduced()
    with pytest.raises(RuntimeError):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.run(["--arch", "whisper-small", "--reduced", "--steps", "1"])
