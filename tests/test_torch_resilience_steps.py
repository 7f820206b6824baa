"""The port's guarded train step on the reduced muonbp-960m, and one
guarded sequence through both packages (``nan_grads@2``,
``spike_loss@4x8``, warmup 2, fp32, constant learning rates).

The claims and tolerances are ``tests/test_torch_resilience.py``'s: the
skip pattern equal, ``ema_loss`` to 1e-6 of its value, losses and
Muon-updated params to 1e-4; a healthy guarded step equals the unguarded
one bitwise, a skipped step leaves every state leaf as it was, and
``lr_scale`` 0.5 applies half the update exactly.
"""

import math

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
    apply_backoff,
    guard_to_meta,
)
from repro_torch.training.train_step import init_train_state, train_step

from test_torch_resilience import (
    ADAM_LR,
    BATCH,
    LR,
    MODEL,
    PERIOD,
    PLAN,
    SEQ,
    STEPS,
    WARMUP,
    WD,
)


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
