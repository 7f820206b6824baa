"""The port's MoE block against the JAX package's ``repro.models.moe``.

The same numpy inputs and weights, made from a seed, go through both
packages on the CPU. Tolerances, each with its reason:

* fp32: ``y``, the load-balance and the z-loss to 1e-5 absolute (values
  of O(0.1-10)). Both sides route identically (the same experts, ranks and
  drops: integer work, compared exactly); only the expert products' and the
  softmaxes' summation order differs, a few fp32 ulps;
* bf16: ``y`` to 2**-6 of max|y|. The two frameworks round the bf16 expert
  products at other places (8 mantissa bits, 2**-8 a rounding), and the
  gate products and the top_k sum add a rounding each.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from repro.models import moe as j_moe
from repro_torch.models import moe

TOL = 1e-5
B, S, D, E, F, K = 2, 16, 32, 8, 24, 2
STYLES = ["topk_softmax", "softmax_topk"]


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _weights(seed=0, experts=E, d=D, f=F):
    return {"router": _rand((d, experts), seed, 0.3), "wi": _rand((experts, d, f), seed + 1, 0.1),
            "wg": _rand((experts, d, f), seed + 2, 0.1), "wo": _rand((experts, f, d), seed + 3, 0.1)}


def _both(x, w, dtype=np.float32):
    """(reference inputs, port inputs) from numpy ``x`` and weights ``w``."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = (jnp.asarray(x).astype(jdt), {k: jnp.asarray(v).astype(jdt) for k, v in w.items()})
    port = (torch.from_numpy(x).to(tdt), {k: torch.from_numpy(v).to(tdt) for k, v in w.items()})
    return ref, port


def _np(t):
    return t.detach().to(torch.float32).numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _reference_drops(top_idx, capacity):
    """The reference's dispatch (``moe.py:82-91``) on its own experts, in
    jnp: (sorted order, validity) of the flat assignments."""
    flat = top_idx.reshape(-1)
    order = jnp.argsort(flat)
    srt = flat[order]
    first = jnp.searchsorted(srt, srt, side="left", method="scan_unrolled")
    rank = jnp.arange(flat.shape[0]) - first
    return np.asarray(order), np.asarray(rank < capacity)


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("tie", [False, True])
def test_route_matches_reference(style, tie):
    """Gates and experts of both router styles; with ``tie`` the logits are
    rounded to a coarse grid, so many rows hold equal values and the order
    among them decides (jax.lax.top_k takes the lower index)."""
    logits = _rand((64, E), 4)
    if tie:
        logits = np.round(logits * 2) / 2
        assert any(len(set(r)) < E for r in logits.tolist())
    jg, ji = j_moe._route(jnp.asarray(logits), K, style)
    g, i = moe._route(torch.from_numpy(logits), K, style)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=TOL)


def test_top_k_takes_the_lower_index_on_ties():
    """Equal values go lower index first; -0.0 ranks below +0.0, as in
    jax.lax.top_k's total order."""
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 0.0],
                      [-0.0, -1.0, 0.0, -0.0, 0.0]])
    vals, idx = moe._top_k(x, 3)
    j_vals, j_idx = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert idx.tolist() == np.asarray(j_idx).tolist() == [[1, 2, 4], [0, 1, 2], [2, 4, 0]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("capacity_factor", [100.0, 1.25, 0.5])
def test_moe_block_matches_reference(style, capacity_factor):
    """Dropless (100), the default capacity (1.25) and a tight one (0.5):
    the same dropped assignments, then y, lb and zl to 1e-5."""
    x, w = _rand((B, S, D), 5), _weights(6)
    (jx, jw), (tx, tw) = _both(x, w)
    kw = dict(top_k=K, capacity_factor=capacity_factor, router_style=style)
    ref, out = j_moe.moe_block(jx, jw, **kw), moe.moe_block(tx, tw, **kw)
    np.testing.assert_allclose(_np(out.y), _np(ref.y), rtol=0, atol=TOL)
    assert abs(float(out.load_balance_loss) - float(ref.load_balance_loss)) <= TOL
    assert abs(float(out.router_z_loss) - float(ref.router_z_loss)) <= TOL

    t = B * S
    capacity = max(1, math.ceil(t * K / E * capacity_factor))
    logits = jnp.asarray(x.reshape(t, D)) @ jnp.asarray(w["router"])
    _, j_idx = j_moe._route(logits, K, style)
    j_order, j_valid = _reference_drops(j_idx, capacity)
    _, t_idx = moe._route(torch.from_numpy(np.asarray(logits)), K, style)
    order, _, valid = moe._dispatch(t_idx.reshape(1, -1), E, capacity)
    np.testing.assert_array_equal(order[0].numpy(), j_order)
    np.testing.assert_array_equal(valid[0].numpy(), j_valid)
    dropped = int((~valid).sum())
    assert (dropped == 0) if capacity_factor == 100.0 else (dropped > 0), dropped


@pytest.mark.parametrize("style", STYLES)
def test_moe_block_gradients_match_reference(style):
    """The backward through routing, dispatch and combine (fp32, with drops):
    the gradients of sum(y * r) + lb + zl for x and every weight to 1e-5."""
    x, w = _rand((B, S, D), 7), _weights(8)
    r = _rand((B, S, D), 9)
    kw = dict(top_k=K, capacity_factor=1.0, router_style=style)

    def j_obj(x_, w_):
        o = j_moe.moe_block(x_, w_, **kw)
        return jnp.sum(o.y * jnp.asarray(r)) + o.load_balance_loss + o.router_z_loss

    jgx, jgw = jax.grad(j_obj, argnums=(0, 1))(jnp.asarray(x),
                                               {k: jnp.asarray(v) for k, v in w.items()})
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = {k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()}
    o = moe.moe_block(tx, tw, **kw)
    (torch.sum(o.y * torch.from_numpy(r)) + o.load_balance_loss + o.router_z_loss).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=0, atol=TOL)
    for k in w:
        np.testing.assert_allclose(tw[k].grad.numpy(), np.asarray(jgw[k]), rtol=0, atol=TOL,
                                   err_msg=k)


def test_moe_block_bf16_matches_reference():
    x, w = _rand((B, S, D), 10), _weights(11)
    (jx, jw), (tx, tw) = _both(x, w, "bfloat16")
    kw = dict(top_k=K, capacity_factor=1.25, router_style="softmax_topk")
    ref, out = j_moe.moe_block(jx, jw, **kw), moe.moe_block(tx, tw, **kw)
    assert out.y.dtype == torch.bfloat16
    scale = float(np.abs(_np(ref.y)).max())
    np.testing.assert_allclose(_np(out.y), _np(ref.y), rtol=0, atol=2.0 ** -6 * scale)


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("seq", [1, 5])
def test_row_grouped_routing_equals_batch_one_calls_of_the_reference(style, seq):
    """group_rows=True is a loop of batch-1 reference calls: y row by row,
    the aux losses as their mean (one decode token a row, as the engine
    routes its slots, and a short sequence a row)."""
    x, w = _rand((4, seq, D), 12), _weights(13)
    kw = dict(top_k=K, capacity_factor=1.25, router_style=style)
    (_, jw), (tx, tw) = _both(x, w)
    out = moe.moe_block(tx, tw, group_rows=True, **kw)
    refs = [j_moe.moe_block(jnp.asarray(x[i:i + 1]), jw, **kw) for i in range(4)]
    np.testing.assert_allclose(_np(out.y), np.concatenate([_np(r.y) for r in refs]),
                               rtol=0, atol=TOL)
    assert abs(float(out.load_balance_loss)
               - np.mean([float(r.load_balance_loss) for r in refs])) <= TOL
    assert abs(float(out.router_z_loss) - np.mean([float(r.router_z_loss) for r in refs])) <= TOL


def test_batch_wide_routing_drops_what_row_grouping_keeps():
    """Four equal decode tokens pick the same two experts: batch-wide
    capacity ceil(4*2/8*1.25) = 2 drops two of each expert's four
    assignments, each row alone (capacity 1) drops none. So a row's output
    depends on its co-batch only under batch-wide routing."""
    row = _rand((1, 1, D), 14)
    x = np.repeat(row, 4, axis=0)
    w = _weights(15)
    (_, _), (tx, tw) = _both(x, w)
    kw = dict(top_k=K, capacity_factor=1.25, router_style="topk_softmax")
    alone = moe.moe_block(torch.from_numpy(row), tw, **kw).y
    grouped = moe.moe_block(tx, tw, group_rows=True, **kw).y
    batched = moe.moe_block(tx, tw, **kw).y
    for i in range(4):   # the same routing; products of other shapes, ulps apart
        torch.testing.assert_close(grouped[i], alone[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(batched[:2], grouped[:2], rtol=0, atol=1e-6)
    assert not torch.equal(batched[2:], grouped[2:])
    assert float(batched[2:].abs().max()) == 0.0   # both of their experts dropped them


def test_moe_block_is_deterministic_and_checks_its_style():
    x, w = _rand((B, S, D), 16), _weights(17)
    (_, _), (tx, tw) = _both(x, w, "bfloat16")
    kw = dict(top_k=K, capacity_factor=1.25, router_style="softmax_topk")
    assert torch.equal(moe.moe_block(tx, tw, **kw).y, moe.moe_block(tx, tw, **kw).y)
    with pytest.raises(ValueError, match="router style"):
        moe.moe_block(tx, tw, top_k=K, router_style="sinkhorn")
