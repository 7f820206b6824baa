"""The optimizer variants of the port (Turbo-Muon, NorMuon, Dion) against the JAX package.

The same numpy parameters and gradients go through both packages on the
CPU, fp32. The reference's NS runs on its jnp backend and once through its
Pallas kernels in interpret mode (``ns_backend="pallas"``, which also runs
its NorMuon kernel), as its own tests run them. Updates and state agree to
max abs <= 1e-5, the tolerance of ``tests/test_torch_optim.py``: updates are
O(lr) = O(1e-2), and the sides differ only in summation order.

Dion's start basis comes from ``jax.random``, which a ``torch.Generator``
cannot reproduce, so its tests carry the reference's state over
(``interop.opt_state_from_numpy``) and hold the port to per-step parity.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from repro.configs import get_config as j_get_config
from repro.core import BlockSpec2D as JBlockSpec2D
from repro.core import VARIANTS as J_VARIANTS
from repro.core import adamw as j_adamw
from repro.core import build_variant as j_build_variant
from repro.core import combine as j_combine
from repro.core import label_tree as j_label_tree
from repro.core import muon as j_muon
from repro.core import phase_for_step as j_phase_for_step
from repro.core import program as j_program
from repro.core import schedule as j_schedule
from repro.core import spectral_norm_est as j_spectral_norm_est
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models.model import init_params as j_init_params
from repro.models.transformer import ShardCtx
from repro.training.train_step import init_train_state as j_init_train_state
from repro.training.train_step import make_train_step_fns
from repro_torch import interop
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.core import (
    VARIANTS,
    DionState,
    LeafSpec,
    VariantSpec,
    build_variant,
    compile_program,
    get_variant,
    label_tree,
    muon,
    spectral_norm_est,
    variant_names,
)
from repro_torch.core.muon import OptState
from repro_torch.kernels import dispatch
from repro_torch.launch import train
from repro_torch.sharding import specs

TOL = 1e-5
LR, WD = 0.02, 0.1


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _flat(tree) -> dict:
    """path -> float64 numpy, for nested dicts (or path-keyed dicts) of leaves."""
    if tree and all(isinstance(k, tuple) for k in tree):
        tree = tree_lib.unflatten(list(tree.items()))
    out = {}
    for path, leaf in tree_lib.flatten_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().to(torch.float64).numpy()
        out[path] = np.asarray(leaf, dtype=np.float64)
    return out


def _assert_trees_close(port, ref, atol=TOL):
    p, r = _flat(port), _flat(ref)
    assert sorted(p) == sorted(r)
    for key in r:
        np.testing.assert_allclose(p[key], r[key], rtol=0, atol=atol, err_msg=str(key))


def _model_case(model: int = 4):
    """Muon leaves of the reduced muonbp-960m: (params, grads, port grids, reference grids)."""
    jcfg = j_get_config("muonbp-960m").reduced()
    params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    cfg = get_config("muonbp-960m").reduced()
    sizes = {"model": model}
    labels = label_tree(params)
    bspecs = specs.block_specs_for(params, specs.param_specs(params, cfg, sizes), sizes)
    bspecs = tree_lib.tree_map(lambda b, l: b if l == "muon" else None, bspecs, labels)
    only = lambda t: tree_lib.tree_map(lambda x, l: x if l == "muon" else None, t, labels)
    j_bspecs = tree_lib.tree_map(lambda b: JBlockSpec2D(b.r, b.c), bspecs)
    return only(params), only(grads), bspecs, j_bspecs


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def test_registry_matches_reference():
    assert variant_names() == tuple(J_VARIANTS) == ("muon", "turbo_muon", "normuon", "dion")
    fields = lambda spec: {k: v for k, v in dataclasses.asdict(spec).items()
                           if k != "description"}
    for name in variant_names():
        assert fields(VARIANTS[name]) == fields(J_VARIANTS[name])
        assert get_variant(name) is VARIANTS[name]
    assert get_variant(None) is VARIANTS["muon"]
    spec = VariantSpec(name="custom", ns_steps_delta=-1)
    assert get_variant(spec) is spec
    with pytest.raises(ValueError, match="unknown optimizer variant"):
        get_variant("muonx")


def test_build_variant_routes():
    params = {"w": torch.from_numpy(_rand((24, 16), 0))}
    grads = {"w": 0.1 * params["w"]}
    opt = build_variant("dion", LR, rank=4, weight_decay=WD, bucketing=False,
                        ns_strategy="plain", block_specs=None)
    state = opt.init(params)
    assert isinstance(state, DionState) and state.basis[("w",)].shape == (16, 4)
    upd, _ = opt.update(grads, state, params, "block")
    assert upd["w"].shape == (24, 16)
    for name in ("muon", "turbo_muon", "normuon"):
        opt = build_variant(name, LR, momentum=0.9, weight_decay=WD)
        state = opt.init(params)
        assert isinstance(state, OptState)
        assert (state.second_moment is None) == (name != "normuon")
        upd, _ = opt.update(grads, state, params, "full")
        assert upd["w"].shape == (24, 16) and bool(torch.isfinite(upd["w"]).all())


def test_muon_rejects_low_rank_variant_spec():
    with pytest.raises(ValueError, match="low-rank"):
        muon(LR, variant=VariantSpec(name="lr", low_rank=True))


# ---------------------------------------------------------------------------
# The pieces: spectral pre-scale, K and stages on the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 48), (48, 16), (3, 24, 40), (2, 2, 13, 150)])
def test_spectral_norm_est_matches_reference(shape):
    x = _rand(shape, 2)
    est = spectral_norm_est(torch.from_numpy(x))
    ref = np.asarray(j_spectral_norm_est(jnp.asarray(x)))
    assert tuple(est.shape) == ref.shape == (*shape[:-2], 1, 1)
    np.testing.assert_allclose(est.numpy(), ref, rtol=1e-5, atol=0)
    exact = np.linalg.norm(x.reshape(-1, *shape[-2:]), ord=2, axis=(-2, -1))
    assert (est.numpy().reshape(-1) <= exact * (1 + 1e-5)).all()


@pytest.mark.parametrize("variant", ["muon", "turbo_muon", "normuon"])
def test_kernel_plans_record_k_and_stages(variant):
    params, _, bspecs, j_bspecs = _model_case()
    spec = VARIANTS[variant]
    k = max(1, 5 + spec.ns_steps_delta)
    stages = dict(ns_steps=k, precondition=spec.precondition, epilogue=spec.epilogue)
    bs = dict(tree_lib.flatten_with_path(bspecs))
    j_bs = dict(tree_lib.flatten_with_path(j_bspecs))
    leaves = tree_lib.flatten_with_path(params)
    port = compile_program([LeafSpec(key=p, shape=x.shape, dtype="float32", block=bs[p])
                            for p, x in leaves], backend="cpu", **stages)
    ref = j_program.compile_program(
        [j_program.LeafSpec(key=p, shape=x.shape, dtype="float32", block=j_bs[p])
         for p, x in leaves], backend="jnp", **stages)
    for phase in ("block", "full"):
        p_ops, r_ops = port.phase(phase).ops, ref.phase(phase).ops
        assert len(p_ops) == len(r_ops)
        for p_op, r_op in zip(p_ops, r_ops):
            assert p_op.packed_shape == r_op.packed_shape
            for field in ("ns_steps", "precondition", "epilogue"):
                assert getattr(p_op.kernel, field) == getattr(r_op.kernel, field)
            assert (p_op.kernel.ns_steps, p_op.kernel.precondition,
                    p_op.kernel.epilogue) == (k, spec.precondition, spec.epilogue)
    if variant == "turbo_muon":
        assert k == 3


@pytest.mark.parametrize("variant,steps,normalize", [
    (None, 5, True), ("turbo_muon", 3, False), ("normuon", 5, True)])
def test_variant_runs_its_chain_length(monkeypatch, variant, steps, normalize):
    """Every NS dispatch of an update runs the variant's K, and Turbo-Muon's
    skips the entry normalization (its input is spectrally pre-scaled)."""
    seen = []
    inner = dispatch.orthogonalize

    def spy(g, **kw):
        seen.append((kw["steps"], kw["normalize"]))
        return inner(g, **kw)

    monkeypatch.setattr(dispatch, "orthogonalize", spy)
    params, grads, bspecs, _ = _model_case()
    opt = muon(LR, LR, period=5, block_specs=bspecs, variant=variant)
    p = interop.params_from_numpy(params, device="cpu")
    opt.update(interop.params_from_numpy(grads, device="cpu"), opt.init(p), p, "block")
    assert seen and set(seen) == {(steps, normalize)}


# ---------------------------------------------------------------------------
# Turbo-Muon and NorMuon updates, state carried
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ns_backend", ["jnp", "pallas"])
@pytest.mark.parametrize("variant", ["normuon", "turbo_muon"])
def test_variant_updates_match_reference(variant, ns_backend):
    """Three updates (full, block, block) with the state carried, leaf by leaf."""
    params, grads, bspecs, j_bspecs = _model_case()
    kw = dict(period=5, weight_decay=WD, variant=variant)
    port = muon(LR, LR, block_specs=bspecs, **kw)
    ref = j_muon(LR, LR, block_specs=j_bspecs, ns_backend=ns_backend, **kw)
    p_params = interop.params_from_numpy(params, device="cpu")
    p_state, r_state = port.init(p_params), ref.init(params)
    for step, phase in enumerate(["full", "block", "block"]):
        g = jax.tree.map(lambda x: x * (1.0 + 0.5 * step), grads)
        p_upd, p_state = port.update(interop.params_from_numpy(g, device="cpu"),
                                     p_state, p_params, phase)
        r_upd, r_state = ref.update(g, r_state, params, phase)
        _assert_trees_close(p_upd, r_upd)
        _assert_trees_close(p_state.momentum, r_state.momentum)
        if variant == "normuon":
            _assert_trees_close(p_state.second_moment, r_state.second_moment, atol=1e-6)
            r_counts = {k: int(c) for k, c in tree_lib.flatten_with_path(
                jax.tree.map(np.asarray, r_state.vcount))}
            assert p_state.vcount == r_counts and set(r_counts.values()) == {1}
        else:
            assert p_state.second_moment is None and r_state.second_moment is None
    assert p_state.count == int(r_state.count) == 3


def test_normuon_block_step_before_any_refresh_is_the_baseline():
    """With zero statistics a block step is exactly the baseline update."""
    params, grads, bspecs, _ = _model_case()
    p = interop.params_from_numpy(params, device="cpu")
    g = interop.params_from_numpy(grads, device="cpu")
    norm, base = (muon(LR, block_specs=bspecs, weight_decay=WD, variant=v)
                  for v in ("normuon", None))
    state = norm.init(p)
    for path, v in state.second_moment.items():
        assert v.shape == p[path[0]][path[1]][path[2]].shape[:-1] + (1,)
        assert v.dtype == torch.float32 and not bool(v.any())
    upd_n, s_n = norm.update(g, state, p, "block")
    upd_b, _ = base.update(g, base.init(p), p, "block")
    for (_, a), (_, b) in zip(tree_lib.flatten_with_path(upd_n),
                              tree_lib.flatten_with_path(upd_b)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert set(s_n.vcount.values()) == {0}


# ---------------------------------------------------------------------------
# Dion
# ---------------------------------------------------------------------------

def _dion_case():
    params, grads, _, _ = _model_case()
    ref = j_build_variant("dion", LR, rank=64, weight_decay=WD)
    r_state = ref.init(params)
    p_state = interop.opt_state_from_numpy(jax.tree.map(np.asarray, r_state._asdict()),
                                           device="cpu")
    port = build_variant("dion", LR, rank=64, weight_decay=WD)
    return params, grads, ref, r_state, port, p_state


def test_dion_updates_match_reference_from_a_carried_basis():
    params, grads, ref, r_state, port, p_state = _dion_case()
    p_params = interop.params_from_numpy(params, device="cpu")
    for step in range(3):
        g = jax.tree.map(lambda x: x * (1.0 + 0.5 * step), grads)
        p_upd, p_state = port.update(interop.params_from_numpy(g, device="cpu"), p_state,
                                     p_params, "full")
        r_upd, r_state = ref.update(g, r_state, params, "full")
        _assert_trees_close(p_upd, r_upd)
        _assert_trees_close(p_state.momentum, r_state.momentum)
        _assert_trees_close(p_state.basis, r_state.basis)
    assert p_state.count == int(r_state.count) == 3
    back = interop.opt_state_to_numpy(p_state)
    _assert_trees_close(back["basis"], r_state.basis)
    assert int(back["count"]) == 3


def test_dion_block_equals_full():
    params, grads, _, _, port, state = _dion_case()
    p = interop.params_from_numpy(params, device="cpu")
    g = interop.params_from_numpy(grads, device="cpu")
    u_b, s_b = port.update(g, state, p, "block")
    u_f, s_f = port.update(g, state, p, "full")
    _assert_trees_close(u_b, u_f, atol=0)
    _assert_trees_close(s_b.momentum, s_f.momentum, atol=0)
    _assert_trees_close(s_b.basis, s_f.basis, atol=0)
    with pytest.raises(ValueError, match="phase"):
        port.update(g, state, p, "stagger:0")
    # The reference's check and message: Dion has no per-leaf gathers to
    # stagger.
    with pytest.raises(ValueError, match="stagger") as ref_err:
        j_build_variant("dion", LR, full_schedule="staggered")
    with pytest.raises(ValueError, match="stagger") as port_err:
        build_variant("dion", LR, full_schedule="staggered")
    assert str(port_err.value) == str(ref_err.value)


def test_dion_init_basis_is_column_normalized_and_seeded_per_width():
    params, _, _, _ = _model_case()
    p = interop.params_from_numpy(params, device="cpu")
    opt = build_variant("dion", LR, rank=64)
    basis = opt.init(p).basis
    again = opt.init(p).basis
    for path, v in basis.items():
        leaf = dict(tree_lib.flatten_with_path(p))[path]
        n = leaf.shape[-1]
        assert tuple(v.shape) == (*leaf.shape[:-2], n, min(64, leaf.shape[-2], n))
        torch.testing.assert_close(torch.linalg.vector_norm(v, dim=-2),
                                   torch.ones(v.shape[:-2] + v.shape[-1:]), rtol=0, atol=1e-5)
        torch.testing.assert_close(v, again[path], rtol=0, atol=0)
    with pytest.raises(ValueError, match="matrices"):
        opt.init({"b": torch.zeros(4)})


# ---------------------------------------------------------------------------
# State interop and the launcher
# ---------------------------------------------------------------------------

def test_normuon_state_round_trips_through_interop():
    params, grads, bspecs, j_bspecs = _model_case()
    ref = j_muon(LR, block_specs=j_bspecs, variant="normuon")
    _, r_state = ref.update(grads, ref.init(params), params, "full")
    as_np = jax.tree.map(np.asarray, r_state._asdict())
    state = interop.opt_state_from_numpy(as_np, device="cpu")
    assert isinstance(state, OptState) and state.count == 1
    assert set(state.vcount.values()) == {1}
    back = interop.opt_state_to_numpy(state)
    assert sorted(back) == sorted(as_np)
    for field in ("momentum", "second_moment", "vcount"):
        _assert_trees_close(back[field], as_np[field], atol=0)
    base = interop.opt_state_from_numpy({"momentum": as_np["momentum"], "count": 2},
                                        device="cpu")
    assert base.second_moment is None and base.vcount is None


def _reference_losses(params, block_specs, variant, steps, period, batch, seq):
    jcfg = j_get_config("muonbp-960m").reduced()
    j_bspecs = tree_lib.tree_map(lambda b: JBlockSpec2D(b.r, b.c), block_specs)
    lr, adam_lr = j_schedule.wsd(LR, steps), j_schedule.wsd(0.008, steps)
    opt = j_combine({"muon": j_muon(lr, lr, period=period, weight_decay=WD,
                                    block_specs=j_bspecs, variant=variant),
                     "adamw": j_adamw(adam_lr, weight_decay=WD)}, j_label_tree(params))
    state = j_init_train_state(jax.tree.map(jnp.asarray, params), opt)
    fns = make_train_step_fns(jcfg, opt, ShardCtx(), donate=False, compute_dtype=jnp.float32)
    pipe = iter(JSyntheticLM(jcfg, batch, seq, seed=0))
    losses = []
    for t in range(steps):
        state, metrics = fns[j_phase_for_step(t, period)](
            state, {k: jnp.asarray(v) for k, v in next(pipe).items()})
        losses.append(float(metrics["loss"]))
    return losses


def test_six_normuon_launcher_steps_track_the_reference():
    jcfg = j_get_config("muonbp-960m").reduced()
    params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg))
    argv = ["--reduced", "--optimizer", "muonbp", "--optimizer-variant", "normuon",
            "--period", "5", "--mesh-model", "4", "--steps", "6", "--batch", "2", "--seq", "32",
            "--compute-dtype", "float32", "--device", "cpu"]
    run = train.run(argv, params=interop.params_from_numpy(params, device="cpu"))
    assert [r["phase"] for r in run.records] == ["full", "block", "block", "block", "block",
                                                 "full"]
    ref = _reference_losses(params, run.block_specs, "normuon", 6, 5, 2, 32)
    np.testing.assert_allclose([r["loss"] for r in run.records], ref, rtol=0, atol=1e-4)
    muon_state = run.state.opt_state.inner["muon"]
    assert set(muon_state.vcount.values()) == {2}


def test_launcher_dion_flag_and_variant_agree():
    argv = ["--reduced", "--steps", "2", "--batch", "1", "--seq", "16", "--mesh-model", "2",
            "--device", "cpu", "--compute-dtype", "float32"]
    by_flag = train.run(argv + ["--optimizer", "dion"]).records
    by_variant = train.run(argv + ["--optimizer-variant", "dion"]).records
    assert [r["phase"] for r in by_flag] == ["full", "full"]
    assert [r["loss"] for r in by_flag] == [r["loss"] for r in by_variant]
    turbo = train.run(argv + ["--optimizer-variant", "turbo_muon", "--period", "2"]).records
    assert [r["phase"] for r in turbo] == ["full", "block"]
    assert np.isfinite([r["loss"] for r in by_flag + turbo]).all()


ENGINE_ENV = ("REPRO_NS_BACKEND", "REPRO_NS_STRATEGY", "REPRO_NS_BUCKETING",
              "REPRO_FULL_SCHEDULE", "REPRO_OPTIMIZER_VARIANT")


def _set_engine_env(monkeypatch, env: dict) -> None:
    for name in ENGINE_ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)


@pytest.mark.parametrize("env", [
    {},
    {"REPRO_NS_STRATEGY": "fused_chain", "REPRO_NS_BUCKETING": "0",
     "REPRO_FULL_SCHEDULE": "barrier", "REPRO_OPTIMIZER_VARIANT": "normuon"},
    {"REPRO_NS_BUCKETING": "off", "REPRO_OPTIMIZER_VARIANT": "turbo_muon"},
], ids=["defaults", "all_set", "bucketing_off"])
def test_ns_engine_config_from_env_matches_reference(monkeypatch, env):
    """Every field but the reference's ``backend`` (which has no counterpart)
    reads the same environment the same way."""
    from repro.configs.base import NSEngineConfig as JNSEngineConfig
    from repro_torch.configs import NSEngineConfig

    _set_engine_env(monkeypatch, env)
    ref = dataclasses.asdict(JNSEngineConfig.from_env())
    ref.pop("backend")
    assert dataclasses.asdict(NSEngineConfig.from_env()) == ref


def _launch_with_env(monkeypatch, env: dict, flags: list) -> tuple:
    """(losses, NS dispatches by strategy, muon state) of two reduced
    launcher steps (full, block) under ``env`` and ``flags``."""
    _set_engine_env(monkeypatch, env)
    run = train.run(["--reduced", "--steps", "2", "--batch", "1", "--seq", "16", "--period",
                     "2", "--mesh-model", "2", "--device", "cpu", "--compute-dtype",
                     "float32"] + flags)
    launches = {k.split(".")[-1]: v for k, v in run.counters.items()
                if k.startswith("ns_launch.")}
    return [r["loss"] for r in run.records], launches, run.state.opt_state.inner["muon"]


def test_launcher_applies_the_engine_env(monkeypatch):
    """The reference's launcher builds its optimizer from
    ``NSEngineConfig.from_env()``: the environment alone gives the run its
    flags give."""
    env = {"REPRO_NS_STRATEGY": "plain", "REPRO_NS_BUCKETING": "0",
           "REPRO_OPTIMIZER_VARIANT": "normuon"}
    by_env = _launch_with_env(monkeypatch, env, [])
    by_flags = _launch_with_env(monkeypatch, {}, ["--ns-strategy", "plain", "--no-ns-bucketing",
                                                  "--optimizer-variant", "normuon"])
    assert by_env[0] == by_flags[0] and by_env[1] == by_flags[1]
    assert set(by_env[1]) == {"plain"}
    assert by_env[2].vcount   # NorMuon's row statistics


@pytest.mark.parametrize("flags, want", [
    ([], dict(strategy="plain", bucketing=False, full_schedule="barrier", variant="normuon")),
    (["--ns-strategy", "auto", "--full-schedule", "pipelined", "--optimizer-variant", "muon"],
     dict(strategy="auto", bucketing=False, full_schedule="pipelined", variant="muon")),
], ids=["env", "flags_beat_env"])
def test_engine_config_flags_beat_env(monkeypatch, flags, want):
    from repro_torch.configs import NSEngineConfig

    _set_engine_env(monkeypatch, {"REPRO_NS_STRATEGY": "plain", "REPRO_NS_BUCKETING": "0",
                                  "REPRO_FULL_SCHEDULE": "barrier",
                                  "REPRO_OPTIMIZER_VARIANT": "normuon"})
    assert train.engine_config(train.parser().parse_args(flags)) == NSEngineConfig(**want)
