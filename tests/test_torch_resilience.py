"""The port's guarded step, escalation ladder and fault grammar against the reference.

Mirrors the single-device cases of ``tests/test_resilience.py`` on the port
(the predicate, the ladder, the meta and the fault grammar here; the
guarded steps in ``tests/test_torch_resilience_steps.py``) and runs one
guarded sequence through both packages: the reduced
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

import os
import signal
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from repro.training import faults as j_faults
from repro.training import resilience as j_resilience
from repro_torch import interop
from repro_torch import tree as tree_lib
from repro_torch.training import faults
from repro_torch.training.faults import Fault, FaultPlan
from repro_torch.training.resilience import (
    EscalationPolicy,
    Escalator,
    GuardConfig,
    GuardState,
    debiased_ema,
    fold_observation,
    guard_from_meta,
    guard_to_meta,
    health_check,
    init_guard_state,
)

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
