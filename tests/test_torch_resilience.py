"""The port's guarded step, escalation ladder and fault grammar against the reference.

Mirrors the single-device cases of ``tests/test_resilience.py`` on the port
and runs one guarded sequence through both packages: the reduced
muonbp-960m on a 4-way block grid, fp32 compute, constant learning rates,
warmup 2, ``nan_grads@2`` and ``spike_loss@4x8``, from the reference's
weights and the same ``SyntheticLM`` batches, through the reference's
``make_train_step_fns(..., guard=, fault=)`` with ``ShardCtx()`` and the
port's ``train_step``. The skip pattern (``healthy``, ``skipped``, the
forced full step) must be equal. ``ema_loss`` agrees to 1e-6 of its value
(it averages the losses, which the two packages sum in another order:
~7e-7 relative here); the losses and the Muon-updated params to 1e-4
(fp32; the argument of ``tests/test_torch_slice.py``), the AdamW-updated
params as ``_assert_params_track`` states. The guard's own claims are
exact: a healthy guarded step equals the unguarded one bitwise
(``torch.equal``), a skipped step leaves every state leaf as it was, and
``lr_scale`` 0.5 applies half the update exactly.
"""

import math
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import BlockSpec2D as JBlockSpec2D
from repro.core import adamw as j_adamw
from repro.core import combine as j_combine
from repro.core import label_tree as j_label_tree
from repro.core import muon as j_muon
from repro.core import phase_for_step as j_phase_for_step
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models.model import init_params as j_init_params
from repro.models.transformer import ShardCtx
from repro.training import faults as j_faults
from repro.training import resilience as j_resilience
from repro.training.train_step import init_train_state as j_init_train_state
from repro.training.train_step import make_train_step_fns
from repro_torch import interop
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.core import adamw, build_variant, combine, label_tree, muon
from repro_torch.core.combine import apply_updates
from repro_torch.core.muon import phase_for_step
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train
from repro_torch.sharding import specs as sh
from repro_torch.training import faults, resilience
from repro_torch.training.faults import Fault, FaultPlan
from repro_torch.training.resilience import (
    EscalationPolicy,
    Escalator,
    GuardConfig,
    GuardState,
    apply_backoff,
    debiased_ema,
    fold_observation,
    guard_from_meta,
    guard_to_meta,
    health_check,
    init_guard_state,
)
from repro_torch.training.train_step import init_train_state, train_step

ROOT = Path(__file__).resolve().parents[1]
LR, ADAM_LR, WD, PERIOD, MODEL, BATCH, SEQ = 0.02, 0.008, 0.1, 5, 4, 2, 32
PLAN, WARMUP, STEPS = "nan_grads@2,spike_loss@4x8", 2, 9
f32, i32 = torch.float32, torch.int32


def _g(ema_loss=5.0, ema_count=100, skipped=0, lr_scale=1.0):
    return GuardState(ema_loss=torch.tensor(ema_loss, dtype=f32),
                      ema_count=torch.tensor(ema_count, dtype=i32),
                      skipped=torch.tensor(skipped, dtype=i32),
                      lr_scale=torch.tensor(lr_scale, dtype=f32))


def _t(x):
    return torch.tensor(x, dtype=f32)


# ---------------------------------------------------------------------------
# Health predicate and EMA, against the reference's functions
# ---------------------------------------------------------------------------

def test_health_check_finiteness():
    cfg = GuardConfig()
    g = init_guard_state()
    ok = _t(2.0)
    assert bool(health_check(cfg, ok, ok, g))
    assert not bool(health_check(cfg, _t(np.nan), ok, g))
    assert not bool(health_check(cfg, ok, _t(np.inf), g))
    assert not bool(health_check(cfg, _t(-np.inf), ok, g))


def test_health_check_spike_after_warmup_only():
    cfg = GuardConfig(spike_factor=3.0, ema_beta=0.9, warmup_steps=10)
    warm = _g(ema_loss=5.0 * (1 - 0.9 ** 100), ema_count=100)
    assert not bool(health_check(cfg, _t(50.0), _t(1.0), warm))
    assert bool(health_check(cfg, _t(10.0), _t(1.0), warm))
    cold = _g(ema_loss=0.5, ema_count=3)
    assert bool(health_check(cfg, _t(50.0), _t(1.0), cold))


@pytest.mark.parametrize("loss,healthy", [(7.5, True), (np.nan, False), (3.25, True)])
def test_fold_and_debias_match_the_reference(loss, healthy):
    """One observation folded into a guard state: the same EMA, count, skips
    and debiased EMA as the reference's functions, to fp32 rounding."""
    cfg = GuardConfig(ema_beta=0.98)
    start = j_resilience.GuardState(jnp.float32(1.25), jnp.int32(7), jnp.int32(2),
                                    jnp.float32(0.5))
    port = fold_observation(cfg, interop.guard_from_numpy(
        {k: np.asarray(v) for k, v in start._asdict().items()}, device="cpu"),
        _t(loss), torch.tensor(healthy))
    ref = j_resilience.fold_observation(j_resilience.GuardConfig(ema_beta=0.98), start,
                                        jnp.float32(loss), jnp.bool_(healthy))
    got = interop.guard_to_numpy(port)
    for name, want in ref._asdict().items():
        np.testing.assert_allclose(got[name], np.asarray(want), rtol=1e-6, atol=0)
        assert got[name].dtype == np.asarray(want).dtype
    np.testing.assert_allclose(
        float(debiased_ema(cfg, port)),
        float(j_resilience.debiased_ema(j_resilience.GuardConfig(ema_beta=0.98), ref)),
        rtol=1e-6)


def test_debiased_ema_matches_first_sample():
    cfg = GuardConfig(ema_beta=0.98)
    g = fold_observation(cfg, init_guard_state(), _t(7.5), torch.tensor(True))
    assert float(debiased_ema(cfg, g)) == pytest.approx(7.5, rel=1e-6)
    assert int(g.ema_count) == 1 and int(g.skipped) == 0


def test_fold_observation_unhealthy_freezes_ema():
    g1 = fold_observation(GuardConfig(), _g(ema_loss=1.25, ema_count=7, skipped=2),
                          _t(np.nan), torch.tensor(False))
    assert float(g1.ema_loss) == 1.25
    assert int(g1.ema_count) == 7 and int(g1.skipped) == 3 and float(g1.lr_scale) == 1.0
    assert g1.ema_loss.dtype == f32 and g1.skipped.dtype == i32


# ---------------------------------------------------------------------------
# Escalation ladder: the same actions as the reference's, step for step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy,totals", [
    (dict(force_full_after=1, backoff_after=3, abort_after=6), [1, 2, 3, 4, 5, 6, 7]),
    (dict(force_full_after=1, backoff_after=2, abort_after=4), [1, 2, 2, 3, 3, 4, 5, 6, 7]),
    (dict(force_full_after=0, backoff_after=0, abort_after=2), [1, 2, 2, 3, 4]),
])
def test_escalator_walks_the_reference_ladder(policy, totals):
    port = Escalator(EscalationPolicy(**policy))
    ref = j_resilience.Escalator(j_resilience.EscalationPolicy(**policy))
    for step, total in enumerate(totals):
        assert port.observe(step, total) == ref.observe(step, total)
        assert port.consecutive == ref.consecutive
    assert port.history == ref.history


def test_escalator_walks_the_ladder():
    esc = Escalator(EscalationPolicy(force_full_after=1, backoff_after=3, abort_after=6))
    actions = [esc.observe(step, step + 1) for step in range(7)]
    assert actions == ["force_full", "force_full", "backoff", "backoff", "backoff", "abort",
                       "abort"]
    assert esc.history[0] == (0, "force_full")


def test_escalator_resume_seeding():
    esc = Escalator(EscalationPolicy(force_full_after=1))
    esc._last_total = 5
    assert esc.observe(10, 5) == "none"
    assert esc.observe(11, 6) == "force_full"


# ---------------------------------------------------------------------------
# Guard-state meta and the fault grammar
# ---------------------------------------------------------------------------

def test_guard_meta_roundtrip_across_packages():
    """The meta dict is the reference's: either package reads the other's."""
    g = _g(ema_loss=1.5, ema_count=42, skipped=3, lr_scale=0.25)
    meta = guard_to_meta(g)
    ref = j_resilience.guard_from_meta(meta)
    assert j_resilience.guard_to_meta(ref) == meta
    g2 = guard_from_meta(j_resilience.guard_to_meta(ref))
    assert guard_to_meta(g2) == meta
    assert g2.ema_count.dtype == i32 and g2.lr_scale.dtype == f32
    assert guard_to_meta(None) is None
    assert int(guard_from_meta(None).skipped) == 0


@pytest.mark.parametrize("spec", ["nan_grads@7,spike_loss@9x8,kill_in_save@12",
                                  "inf_grads@0,kill_mid_save@3,slow_step@2x0.5",
                                  "corrupt_cache@4,kill_in_decode@5,spike_loss@1x2.5"])
def test_fault_plan_grammar_matches_reference(spec):
    plan, ref = FaultPlan.parse(spec), j_faults.FaultPlan.parse(spec)
    assert plan.spec() == ref.spec() == spec
    assert plan.without_kills().spec() == ref.without_kills().spec()
    for step in range(14):
        a, b = plan.grad_fault(step), ref.grad_fault(step)
        assert (a and (a.kind, a.step, a.scale)) == (b and (b.kind, b.step, b.scale))
    assert [(f.kind, f.step, f.scale) for f in plan.faults] == \
        [(f.kind, f.step, f.scale) for f in ref.faults]


def test_fault_plan_parse_errors():
    plan = FaultPlan.parse("nan_grads@7,spike_loss@9x8,kill_in_save@12")
    assert plan.grad_fault(7) == Fault("nan_grads", 7)
    assert plan.grad_fault(12) is None
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan.parse("meteor_strike@3")
    with pytest.raises(ValueError, match="bad fault spec"):
        FaultPlan.parse("nan_grads")


def test_fault_plan_kill_fires_once_at_or_after_step():
    plan = FaultPlan.parse("kill_in_save@12")
    assert not plan.take_kill("checkpoint.pre_finalize", 10)
    assert not plan.take_kill("checkpoint.mid_write", 14)
    assert plan.take_kill("checkpoint.pre_finalize", 14)
    assert not plan.take_kill("checkpoint.pre_finalize", 16)


def test_crash_point_sigkills_the_process():
    code = ("from repro_torch.training import faults\n"
            "faults.crash_point('checkpoint.mid_write', 3)\n"
            "faults.set_active(faults.FaultPlan.parse('kill_in_save@2'))\n"
            "faults.crash_point('checkpoint.pre_finalize', 1)\n"
            "print('alive')\n"
            "faults.crash_point('checkpoint.pre_finalize', 2)\n"
            "print('UNREACHABLE')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.pop("REPRO_KILL_MID_SAVE", None)
    env.pop("REPRO_KILL_IN_SAVE", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == -signal.SIGKILL
    assert out.stdout.split() == ["alive"]


def test_inject_matches_reference():
    grads = {"w": torch.ones(3, 2), "b": torch.ones(2)}
    loss = _t(2.5)
    for kind in ("nan_grads", "inf_grads"):
        _, g, _ = faults.inject(Fault(kind, 0), loss, grads, {"loss": loss})
        want = np.nan if kind == "nan_grads" else np.inf
        assert all(np.array_equal(t.numpy(), np.full(t.shape, want, np.float32), equal_nan=True)
                   for t in tree_lib.leaves(g))
    spiked, g, m = faults.inject(Fault("spike_loss", 0, scale=8.0), loss, grads, {"loss": loss})
    ref, _, _ = j_faults.inject(j_faults.Fault("spike_loss", 0, 8.0), jnp.float32(2.5), {}, {})
    assert float(spiked) == float(m["loss"]) == float(ref) == 20.0
    assert g is grads
    with pytest.raises(ValueError, match="not an in-step fault"):
        faults.inject(Fault("kill_in_save", 0), loss, grads, {})


# ---------------------------------------------------------------------------
# The port's guarded step on the reduced muonbp-960m
# ---------------------------------------------------------------------------

def _reference_case():
    jcfg = j_get_config("muonbp-960m").reduced()
    return jcfg, jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg))


def _port_setup(params_np, variant=None, block_specs=None):
    params = interop.params_from_numpy(params_np, device="cpu")
    if variant is not None and variant == "dion":
        matrix = build_variant("dion", LR, rank=8, weight_decay=WD)
    else:
        matrix = muon(LR, LR, period=3, weight_decay=WD, block_specs=block_specs,
                      variant=variant)
    opt = combine({"muon": matrix, "adamw": adamw(ADAM_LR, weight_decay=WD)},
                  label_tree(params))
    return params, opt


def _batches(cfg, n, seed=0):
    it = iter(SyntheticLM(cfg, BATCH, SEQ, seed=seed))
    return [{k: torch.from_numpy(v).long() for k, v in next(it).items()} for _ in range(n)]


def _leaves_equal(a, b) -> bool:
    la, lb = tree_lib.leaves(_as_tree(a)), tree_lib.leaves(_as_tree(b))
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))


def _as_tree(state):
    """Any state as a nested dict (NamedTuples by field, path dicts by path)."""
    if isinstance(state, tuple) and hasattr(state, "_asdict"):
        return {k: _as_tree(v) for k, v in state._asdict().items()}
    if isinstance(state, dict):
        return {"/".join(k) if isinstance(k, tuple) else k: _as_tree(v)
                for k, v in state.items()}
    return state


@pytest.mark.parametrize("variant", ["muon", "turbo_muon", "normuon", "dion"])
def test_healthy_guarded_steps_equal_unguarded_steps_bitwise(variant):
    jcfg, params_np = _reference_case()
    cfg = get_config("muonbp-960m").reduced()
    params, opt = _port_setup(params_np, variant)
    s_u = init_train_state(params, opt)
    s_g = init_train_state(params, opt, guard=True)
    for t, batch in enumerate(_batches(cfg, 4)):
        phase = "full" if t % 3 == 0 else "block"
        kw = dict(cfg=cfg, optimizer=opt, phase=phase, compute_dtype=torch.float32)
        s_u, _ = train_step(s_u, batch, **kw)
        s_g, m = train_step(s_g, batch, guard=GuardConfig(), **kw)
    assert _leaves_equal(s_u.params, s_g.params)
    assert _leaves_equal(s_u.opt_state, s_g.opt_state)
    assert int(m["skipped"]) == 0 and int(m["healthy"]) == 1 and float(m["lr_scale"]) == 1.0
    assert int(s_g.guard.ema_count) == 4 and s_u.guard is None


@pytest.mark.parametrize("variant,kind", [("muon", "nan_grads"), ("muon", "inf_grads"),
                                          ("normuon", "nan_grads"), ("dion", "inf_grads")])
def test_guard_skip_leaves_every_state_leaf_untouched(variant, kind):
    """A non-finite step runs no update: params, momentum, NorMuon's second
    moment, Dion's basis and AdamW's moments stay bitwise as they were; the
    guard state still advances, and the next clean step recovers."""
    _, params_np = _reference_case()
    cfg = get_config("muonbp-960m").reduced()
    params, opt = _port_setup(params_np, variant)
    state = init_train_state(params, opt, guard=True)
    batches = _batches(cfg, 4)
    kw = dict(cfg=cfg, optimizer=opt, compute_dtype=torch.float32, guard=GuardConfig())
    for phase, batch in zip(("full", "block"), batches):
        state, _ = train_step(state, batch, phase=phase, **kw)
    before = tree_lib.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
                               _as_tree(state))
    state, m = train_step(state, batches[2], phase="block", fault=Fault(kind, 2), **kw)
    assert int(m["healthy"]) == 0 and int(m["skipped"]) == 1
    assert _leaves_equal(before["params"], state.params)
    assert _leaves_equal(before["opt_state"], state.opt_state)
    assert int(state.guard.skipped) == 1 and state.step == 3
    state, m = train_step(state, batches[3], phase="block", **kw)
    assert int(m["healthy"]) == 1 and math.isfinite(float(m["loss"]))
    assert not _leaves_equal(before["params"], state.params)


def test_unguarded_nonfinite_step_poisons_params():
    _, params_np = _reference_case()
    cfg = get_config("muonbp-960m").reduced()
    params, opt = _port_setup(params_np)
    state, _ = train_step(init_train_state(params, opt), _batches(cfg, 1)[0], cfg=cfg,
                          optimizer=opt, phase="block", fault=Fault("nan_grads", 0))
    assert torch.isnan(tree_lib.leaves(state.params)[0]).any()


@pytest.mark.parametrize("warmup,skipped", [(2, 1), (10, 0)])
def test_loss_spike_is_skipped_only_after_warmup(warmup, skipped):
    _, params_np = _reference_case()
    cfg = get_config("muonbp-960m").reduced()
    params, opt = _port_setup(params_np)
    gcfg = GuardConfig(spike_factor=3.0, warmup_steps=warmup)
    state = init_train_state(params, opt, guard=True)
    batches = _batches(cfg, 4)
    kw = dict(cfg=cfg, optimizer=opt, phase="block", compute_dtype=torch.float32, guard=gcfg)
    for batch in batches[:3]:
        state, _ = train_step(state, batch, **kw)
    before = state.params
    state, m = train_step(state, batches[3], fault=Fault("spike_loss", 3, scale=50.0), **kw)
    assert int(m["skipped"]) == skipped and int(m["healthy"]) == 1 - skipped
    assert math.isfinite(float(m["loss"]))
    assert _leaves_equal(before, state.params) == bool(skipped)


def test_backoff_applies_half_the_update_exactly():
    """lr_scale 0.5 makes the step apply exactly half of the unguarded
    update; the momentum is not scaled."""
    _, params_np = _reference_case()
    cfg = get_config("muonbp-960m").reduced()
    params, opt = _port_setup(params_np)
    batches = _batches(cfg, 2)
    kw = dict(cfg=cfg, optimizer=opt, compute_dtype=torch.float32)
    base, _ = train_step(init_train_state(params, opt, guard=True), batches[0], phase="full",
                         guard=GuardConfig(), **kw)
    s1, m1 = train_step(base, batches[1], phase="block", guard=GuardConfig(), **kw)
    s2, m2 = train_step(apply_backoff(base, 0.5), batches[1], phase="block",
                        guard=GuardConfig(), **kw)
    assert float(m1["lr_scale"]) == 1.0 and float(m2["lr_scale"]) == 0.5
    from repro_torch.training.train_step import loss_and_grads

    _, _, grads = loss_and_grads(base.params, batches[1], cfg, torch.float32)
    updates, _ = opt.update(grads, base.opt_state, base.params, "block")
    half = apply_updates(base.params, tree_lib.tree_map(lambda u: 0.5 * u, updates))
    assert _leaves_equal(s2.params, half)
    assert _leaves_equal(s1.opt_state, s2.opt_state)


# ---------------------------------------------------------------------------
# The guarded sequence through both packages
# ---------------------------------------------------------------------------

def _grid(params_np):
    cfg = get_config("muonbp-960m").reduced()
    p = interop.params_from_numpy(params_np, device="cpu")
    sizes = {"model": MODEL}
    bspecs = sh.block_specs_for(p, sh.param_specs(p, cfg, sizes), sizes)
    labels = label_tree(p)
    return tree_lib.tree_map(lambda b, l: b if l == "muon" else None, bspecs, labels)


def _assert_params_track(port_params, ref_params, applied: int):
    """Muon leaves to 1e-4 everywhere. AdamW leaves to 1e-4 on all but 1e-3
    of their entries: AdamW's step is about -lr g / |g|, so an entry whose
    gradient is within rounding of 0 can move by up to ``ADAM_LR`` a step in
    one package and not in the other; those entries stay within ``applied``
    such steps."""
    got = dict(tree_lib.flatten_with_path(interop.params_to_numpy(port_params)))
    labels = dict(tree_lib.flatten_with_path(label_tree(port_params)))
    for path, want in tree_lib.flatten_with_path(jax.tree.map(np.asarray, ref_params)):
        diff = np.abs(got[path] - want)
        if labels[path] == "muon":
            assert diff.max() <= 1e-4, (path, diff.max())
        else:
            assert np.mean(diff > 1e-4) <= 1e-3 and diff.max() <= applied * ADAM_LR, (
                path, np.mean(diff > 1e-4), diff.max())


def _reference_sequence(jcfg, params_np, bspecs):
    j_bspecs = tree_lib.tree_map(lambda b: JBlockSpec2D(b.r, b.c), bspecs)
    opt = j_combine({"muon": j_muon(LR, LR, period=PERIOD, weight_decay=WD, block_specs=j_bspecs),
                     "adamw": j_adamw(ADAM_LR, weight_decay=WD)}, j_label_tree(params_np))
    gcfg = j_resilience.GuardConfig(warmup_steps=WARMUP)
    plan = j_faults.FaultPlan.parse(PLAN)
    state = j_init_train_state(jax.tree.map(jnp.asarray, params_np), opt, guard=True)
    kw = dict(donate=False, compute_dtype=jnp.float32, guard=gcfg)
    clean = make_train_step_fns(jcfg, opt, ShardCtx(), **kw)
    esc = j_resilience.Escalator(j_resilience.EscalationPolicy())
    pipe = iter(JSyntheticLM(jcfg, BATCH, SEQ, seed=0))
    out, forced = [], False
    for t in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in next(pipe).items()}
        phase = "full" if forced else j_phase_for_step(t, PERIOD)
        fault = plan.grad_fault(t)
        fn = clean[phase] if fault is None else make_train_step_fns(
            jcfg, opt, ShardCtx(), fault=fault, phases=(phase,), **kw)[phase]
        state, m = fn(state, batch)
        forced = esc.observe(t, int(m["skipped"])) == "force_full"
        out.append((phase, int(m["healthy"]), int(m["skipped"]), float(m["ema_loss"]),
                    float(m["loss"])))
    return out, state


def _port_sequence(params_np, bspecs):
    cfg = get_config("muonbp-960m").reduced()
    params = interop.params_from_numpy(params_np, device="cpu")
    opt = combine({"muon": muon(LR, LR, period=PERIOD, weight_decay=WD, block_specs=bspecs),
                   "adamw": adamw(ADAM_LR, weight_decay=WD)}, label_tree(params))
    gcfg, plan = GuardConfig(warmup_steps=WARMUP), FaultPlan.parse(PLAN)
    state = init_train_state(params, opt, guard=True)
    esc = Escalator(EscalationPolicy())
    out, forced = [], False
    for t, batch in enumerate(_batches(cfg, STEPS)):
        phase = "full" if forced else phase_for_step(t, PERIOD)
        state, m = train_step(state, batch, cfg=cfg, optimizer=opt, phase=phase,
                              compute_dtype=torch.float32, guard=gcfg, fault=plan.grad_fault(t))
        forced = esc.observe(t, int(m["skipped"])) == "force_full"
        out.append((phase, int(m["healthy"]), int(m["skipped"]), float(m["ema_loss"]),
                    float(m["loss"])))
    return out, state


def test_guarded_sequence_matches_the_reference():
    jcfg, params_np = _reference_case()
    bspecs = _grid(params_np)
    ref, r_state = _reference_sequence(jcfg, params_np, bspecs)
    port, p_state = _port_sequence(params_np, bspecs)
    assert [r[:3] for r in port] == [r[:3] for r in ref]
    # Steps 2 (NaN gradients) and 4 (the spike) are skipped; the escalator
    # forces step 3 to 'full'.
    assert [r[1] for r in port] == [1, 1, 0, 1, 0, 1, 1, 1, 1]
    assert [r[0] for r in port][:6] == ["full", "block", "block", "full", "block", "full"]
    assert port[-1][2] == 2
    np.testing.assert_allclose([r[3] for r in port], [r[3] for r in ref], rtol=1e-6, atol=0)
    np.testing.assert_allclose([r[4] for r in port], [r[4] for r in ref], rtol=0, atol=1e-4)
    _assert_params_track(p_state.params, r_state.params, applied=STEPS - 2)
    for name, want in j_resilience.guard_to_meta(r_state.guard).items():
        assert resilience.guard_to_meta(p_state.guard)[name] == pytest.approx(want, rel=1e-6)

    # The launcher walks the same ladder.
    argv = ["--reduced", "--mesh-model", str(MODEL), "--steps", str(STEPS), "--batch",
            str(BATCH), "--seq", str(SEQ), "--period", str(PERIOD), "--lr", str(LR),
            "--adam-lr", str(ADAM_LR), "--schedule", "const", "--compute-dtype", "float32",
            "--device", "cpu", "--guard", "--guard-warmup", str(WARMUP), "--fault-plan", PLAN]
    run = train.run(argv, params=interop.params_from_numpy(params_np, device="cpu"))
    assert [(r["phase"], r["healthy"], r["skipped"]) for r in run.records] == \
        [r[:3] for r in port]
    np.testing.assert_allclose([r["loss"] for r in run.records], [r[4] for r in port],
                               rtol=0, atol=0)
    assert run.counters["guard.skipped_steps"] == 2
    assert run.counters["escalation.force_full"] == 2


def test_launcher_aborts_with_exit_3_after_consecutive_skips(tmp_path, capsys):
    argv = ["--reduced", "--steps", "6", "--batch", "1", "--seq", "8", "--period", "2",
            "--device", "cpu", "--guard", "--guard-abort-after", "2",
            "--fault-plan", "nan_grads@1,inf_grads@2", "--checkpoint-dir", str(tmp_path),
            "--log-every", "100"]
    with pytest.raises(SystemExit) as ei:
        train.run(argv)
    assert ei.value.code == 3
    out = capsys.readouterr().out
    assert '"event": "abort", "step": 2' in out
    # The abort snapshot is written and verifies.
    from repro_torch.training import checkpoint

    path, meta = checkpoint.latest_valid(str(tmp_path))
    assert meta["step"] == 2 and meta["guard"]["skipped"] == 2
    assert faults.active() is None  # the run's fault plan is removed after it
