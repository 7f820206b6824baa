"""Muon, AdamW, combine and the LR schedules of the port against the JAX package.

The same numpy parameters and gradients go through both packages. The
reference's NS runs on its plain jnp backend, and once through its Pallas
kernels in interpret mode (``ns_backend="pallas"``, as its own tests run
them on the CPU). All fp32 on the CPU: updates agree to max abs <= 1e-5,
the reference's own tolerance between its kernels and its jnp chain
(``tests/test_kernels.py:74``); updates are O(lr) = O(1e-2), so that is a
relative 1e-3 of the smallest update that matters.
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
from repro.core import block_muon as j_block_muon
from repro.core import combine as j_combine
from repro.core import label_tree as j_label_tree
from repro.core import muon as j_muon
from repro.core import muon_full as j_muon_full
from repro.core import phase_for_step as j_phase_for_step
from repro.core import schedule as j_schedule
from repro.models.model import init_params as j_init_params
from repro_torch import interop
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.core import (
    BlockSpec2D,
    adamw,
    apply_updates,
    block_muon,
    combine,
    label_tree,
    muon,
    muon_full,
    orthogonalize_plain,
    partition_blocks,
    phase_for_step,
    unpartition_blocks,
)
from repro_torch.core import schedule
from repro_torch.sharding import specs

TOL = 1e-5


def _flat(tree) -> dict:
    """path -> float64 numpy, for nested dicts of torch or jax leaves."""
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


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# A reduced muonbp-960m with the 4-way block grid, in both packages
# ---------------------------------------------------------------------------

def _model_case(model: int = 4):
    """(numpy params, numpy grads, port block specs, reference block specs)."""
    jcfg = j_get_config("muonbp-960m").reduced()
    params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    cfg = get_config("muonbp-960m").reduced()
    sizes = {"model": model}
    bspecs = specs.block_specs_for(params, specs.param_specs(params, cfg, sizes), sizes)
    labels = label_tree(params)
    bspecs = tree_lib.tree_map(lambda b, l: b if l == "muon" else None, bspecs, labels)
    j_bspecs = tree_lib.tree_map(lambda b: JBlockSpec2D(b.r, b.c), bspecs)
    return params, grads, bspecs, j_bspecs


def _muon_only(tree, labels):
    return tree_lib.tree_map(lambda x, l: x if l == "muon" else None, tree, labels)


@pytest.mark.parametrize("ns_backend", ["jnp", "pallas"])
def test_muon_block_then_full_matches_reference(ns_backend):
    """Three updates (full, block, block) with momentum carried, leaf by leaf."""
    params, grads, bspecs, j_bspecs = _model_case()
    labels = label_tree(params)
    params, grads = _muon_only(params, labels), _muon_only(grads, labels)
    kw = dict(period=5, weight_decay=0.1)
    port = muon(0.02, 0.02, block_specs=bspecs, **kw)
    ref = j_muon(0.02, 0.02, block_specs=j_bspecs, ns_backend=ns_backend, **kw)
    p_params = interop.params_from_numpy(params, device="cpu")
    p_state, r_state = port.init(p_params), ref.init(params)
    for step, phase in enumerate(["full", "block", "block"]):
        g = jax.tree.map(lambda x: x * (1.0 + 0.5 * step), grads)
        p_upd, p_state = port.update(interop.params_from_numpy(g, device="cpu"),
                                     p_state, p_params, phase)
        r_upd, r_state = ref.update(g, r_state, params, phase)
        _assert_trees_close(p_upd, r_upd)
        _assert_trees_close(tree_lib.unflatten(list(p_state.momentum.items())), r_state.momentum)
    assert p_state.count == int(r_state.count) == 3


@pytest.mark.parametrize("phase", ["block", "full"])
def test_combined_muon_adamw_matches_reference(phase):
    """combine(muon, adamw) with schedules and weight decay, two updates."""
    params, grads, bspecs, j_bspecs = _model_case()
    lr = schedule.wsd(0.02, 6)
    adam_lr = schedule.wsd(0.008, 6)
    port = combine({"muon": muon(lr, lr, period=5, weight_decay=0.1, block_specs=bspecs),
                    "adamw": adamw(adam_lr, weight_decay=0.1)}, label_tree(params))
    j_lr, j_adam_lr = j_schedule.wsd(0.02, 6), j_schedule.wsd(0.008, 6)
    ref = j_combine({"muon": j_muon(j_lr, j_lr, period=5, weight_decay=0.1,
                                    block_specs=j_bspecs),
                     "adamw": j_adamw(j_adam_lr, weight_decay=0.1)}, j_label_tree(params))
    p_params = interop.params_from_numpy(params, device="cpu")
    p_grads = interop.params_from_numpy(grads, device="cpu")
    p_state, r_state = port.init(p_params), ref.init(params)
    for _ in range(2):
        p_upd, p_state = port.update(p_grads, p_state, p_params, phase)
        r_upd, r_state = ref.update(grads, r_state, params, phase)
        _assert_trees_close(p_upd, r_upd)
        p_params = apply_updates(p_params, p_upd)
        params = jax.tree.map(lambda p, u: np.asarray(p + u), params, r_upd)
    _assert_trees_close(p_params, params)


def test_adamw_with_clipping_matches_reference():
    params = {"a": _rand((8, 16), 0), "b": _rand((16,), 1)}
    grads = {"a": 10 * _rand((8, 16), 2), "b": 10 * _rand((16,), 3)}  # clip active
    port, ref = adamw(0.01, weight_decay=0.1), j_adamw(0.01, weight_decay=0.1)
    p_params = interop.params_from_numpy(params, device="cpu")
    p_state, r_state = port.init(p_params), ref.init(params)
    for _ in range(3):
        p_upd, p_state = port.update(interop.params_from_numpy(grads, device="cpu"),
                                     p_state, p_params)
        r_upd, r_state = ref.update(grads, r_state, params)
        _assert_trees_close(p_upd, r_upd, atol=1e-6)
    _assert_trees_close(tree_lib.unflatten(list(p_state.nu.items())), r_state.nu, atol=1e-6)


@pytest.mark.parametrize("case", ["first_step", "decoupled_decay", "grad_clip", "quadratic"])
def test_adamw_cases_of_the_reference_hold(case):
    """The AdamW cases of tests/test_optimizers.py, on the port."""
    p, g = torch.from_numpy(_rand((4, 4), 30)), torch.from_numpy(_rand((4, 4), 31))
    if case == "first_step":
        opt = adamw(0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0, grad_clip=None)
        upd, _ = opt.update({"w": g}, opt.init({"w": p}), {"w": p})
        torch.testing.assert_close(upd["w"], -0.1 * g / (g.abs() + 1e-8), rtol=1e-4, atol=0)
    elif case == "decoupled_decay":
        opt = adamw(0.1, weight_decay=0.5, grad_clip=None)
        w = torch.ones(4)
        upd, _ = opt.update({"w": torch.zeros(4)}, opt.init({"w": w}), {"w": w})
        torch.testing.assert_close(upd["w"], torch.full((4,), -0.05), rtol=0, atol=1e-7)
    elif case == "grad_clip":
        opt = adamw(0.1, grad_clip=1.0)
        w = torch.zeros(4)
        _, state = opt.update({"w": torch.full((4,), 1000.0)}, opt.init({"w": w}), {"w": w})
        assert float(torch.linalg.norm(state.mu[("w",)] / 0.1)) <= 1.01
    else:
        target, w = torch.from_numpy(_rand((8,), 32)), torch.zeros(8)
        opt = adamw(0.1)
        state = opt.init({"w": w})
        for _ in range(200):
            upd, state = opt.update({"w": w - target}, state, {"w": w})
            w = w + upd["w"]
        assert float(torch.linalg.norm(w - target)) < 0.05


def test_muon_rejects_low_rank_variant():
    """As the reference (tests/test_variants.py): Dion is built by
    ``variants.build_variant``, never by ``muon``."""
    with pytest.raises(ValueError, match="low-rank"):
        muon(0.02, variant="dion")


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("wsd", (0.02, 6)), ("wsd", (0.02, 50, 5, 0.3, 0.001)),
    ("cosine", (0.02, 6)), ("cosine", (0.02, 40, 4, 0.1)), ("constant", (0.02,)),
])
def test_schedules_match_reference(name, args):
    port, ref = getattr(schedule, name)(*args), getattr(j_schedule, name)(*args)
    for count in range(0, 60):
        expect = float(ref(jnp.asarray(count, jnp.int32)))
        assert port(count) == pytest.approx(expect, rel=1e-6, abs=1e-9), count


def test_phase_schedule_matches_reference():
    for period in (None, 1, 2, 5):
        assert [phase_for_step(t, period) for t in range(12)] == \
               [j_phase_for_step(t, period) for t in range(12)]


# ---------------------------------------------------------------------------
# The cases of tests/test_muon.py, on the port, each held to the reference
# ---------------------------------------------------------------------------

def _one_update(make_port, make_ref, g, phase, p=None):
    p = np.zeros_like(g) if p is None else p
    port, ref = make_port(), make_ref()
    pt = {"w": torch.from_numpy(p)}
    p_upd, _ = port.update({"w": torch.from_numpy(g)}, port.init(pt), pt, phase)
    r_upd, _ = ref.update({"w": jnp.asarray(g)}, ref.init({"w": jnp.asarray(p)}),
                          {"w": jnp.asarray(p)}, phase)
    np.testing.assert_allclose(p_upd["w"].numpy(), np.asarray(r_upd["w"]), rtol=0, atol=TOL)
    return p_upd["w"]


def test_first_step_is_orthogonalized_gradient():
    g = _rand((16, 32), 10)
    upd = _one_update(lambda: muon_full(0.1, momentum=0.9, rms_match=False),
                      lambda: j_muon_full(0.1, momentum=0.9, rms_match=False), g, "full")
    expect = -0.1 * orthogonalize_plain(1.9 * torch.from_numpy(g), steps=5)
    torch.testing.assert_close(upd, expect, rtol=0, atol=TOL)


def test_block_step_equals_per_block_orth():
    g = _rand((16, 32), 11)
    upd = _one_update(
        lambda: muon(0.1, 0.1, period=5, rms_match=False, block_specs={"w": BlockSpec2D(2, 4)}),
        lambda: j_muon(0.1, 0.1, period=5, rms_match=False,
                       block_specs={"w": JBlockSpec2D(2, 4)}), g, "block")
    bs = BlockSpec2D(2, 4)
    blocks = partition_blocks(1.95 * torch.from_numpy(g), bs)
    expect = -0.1 * unpartition_blocks(orthogonalize_plain(blocks, steps=5), bs)
    torch.testing.assert_close(upd, expect, rtol=0, atol=TOL)


def test_two_stepsizes():
    g = _rand((16, 32), 12)
    make = lambda: muon(0.2, 0.05, period=2, rms_match=False,
                        block_specs={"w": BlockSpec2D(1, 2)})
    make_ref = lambda: j_muon(0.2, 0.05, period=2, rms_match=False,
                              block_specs={"w": JBlockSpec2D(1, 2)})
    full = _one_update(make, make_ref, g, "full")
    block = _one_update(make, make_ref, g, "block")
    assert 2.0 < float(full.norm() / block.norm()) < 8.0


def test_rms_matching_scale():
    g = _rand((64, 256), 13)
    upd = _one_update(lambda: muon_full(1.0, rms_target=0.2),
                      lambda: j_muon_full(1.0, rms_target=0.2), g, "full")
    assert 0.1 < float(upd.pow(2).mean().sqrt()) < 0.3


def test_block_rms_uses_block_dims():
    g = _rand((64, 256), 14)
    make = lambda: muon(1.0, 1.0, period=2, block_specs={"w": BlockSpec2D(1, 4)})
    make_ref = lambda: j_muon(1.0, 1.0, period=2, block_specs={"w": JBlockSpec2D(1, 4)})
    for phase in ("block", "full"):
        upd = _one_update(make, make_ref, g, phase)
        assert 0.1 < float(upd.pow(2).mean().sqrt()) < 0.3, phase


def test_momentum_accumulates():
    g = torch.from_numpy(_rand((16, 32), 15))
    opt = muon_full(0.1, momentum=0.5)
    p = {"w": torch.zeros_like(g)}
    _, s1 = opt.update({"w": g}, opt.init(p), p, "full")
    _, s2 = opt.update({"w": g}, s1, p, "full")
    torch.testing.assert_close(s2.momentum[("w",)], 1.5 * g, rtol=0, atol=1e-6)


def test_weight_decay():
    p = _rand((8, 8), 16)
    upd = _one_update(lambda: muon_full(0.1, weight_decay=0.5, rms_match=False),
                      lambda: j_muon_full(0.1, weight_decay=0.5, rms_match=False),
                      np.zeros((8, 8), np.float32), "full", p=p)
    torch.testing.assert_close(upd, -0.05 * torch.from_numpy(p), rtol=0, atol=TOL)


def test_blockmuon_is_period_none():
    g = _rand((16, 32), 17)
    kw = dict(block_specs={"w": BlockSpec2D(1, 2)}, rms_match=False)
    j_kw = dict(block_specs={"w": JBlockSpec2D(1, 2)}, rms_match=False)
    u1 = _one_update(lambda: block_muon(0.1, **kw), lambda: j_block_muon(0.1, **j_kw), g, "block")
    u2 = _one_update(lambda: muon(0.1, 0.1, period=None, **kw),
                     lambda: j_muon(0.1, 0.1, period=None, **j_kw), g, "block")
    torch.testing.assert_close(u1, u2, rtol=0, atol=0)


def test_combined_optimizer_routes_params():
    raw = {"dense": {"w": _rand((8, 16), 18), "norm_scale": np.ones((8,), np.float32)},
           "embed": _rand((32, 8), 19)}
    params = interop.params_from_numpy(raw, device="cpu")
    labels = label_tree(params)
    assert labels == {"dense": {"w": "muon", "norm_scale": "adamw"}, "embed": "adamw"}
    assert labels == j_label_tree(raw)
    opt = combine({"muon": muon_full(0.1), "adamw": adamw(0.01)}, labels)
    ref = j_combine({"muon": j_muon_full(0.1), "adamw": j_adamw(0.01)}, j_label_tree(raw))
    grads = tree_lib.tree_map(torch.ones_like, params)
    upd, _ = opt.update(grads, opt.init(params), params, "full")
    r_upd, _ = ref.update(jax.tree.map(np.ones_like, raw), ref.init(raw), raw, "full")
    _assert_trees_close(upd, r_upd)
    p2 = apply_updates(params, upd)
    assert all(bool(torch.isfinite(x).all()) for x in tree_lib.leaves(p2))


def test_optimizes_quadratic():
    target = torch.from_numpy(_rand((16, 16), 20))
    kw = dict(rms_match=False, momentum=0.8)
    for make in (lambda: muon_full(0.2, **kw),
                 lambda: block_muon(0.2, block_specs={"w": BlockSpec2D(2, 2)}, **kw),
                 lambda: muon(0.2, 0.2, period=3, block_specs={"w": BlockSpec2D(2, 2)}, **kw)):
        opt = make()
        w = torch.zeros(16, 16)
        state = opt.init({"w": w})
        for t in range(100):
            upd, state = opt.update({"w": w - target}, state, {"w": w}, phase_for_step(t, 3))
            w = w + upd["w"]
        assert 0.5 * float(((w - target) ** 2).sum()) < 0.1 * 0.5 * float((target ** 2).sum())
