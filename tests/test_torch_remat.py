"""Activation checkpointing in train mode (``models.transformer.forward(remat=)``)
against the JAX package, on the CPU at reduced size, for every arch: dense
(muonbp-960m, gemma2-9b), MoE (olmoe-1b-7b), SSM (mamba2-1.3b), hybrid
(hymba-1.5b), VLM (internvl2-1b) and audio (whisper-small).

Held:

* with ``remat`` on and off, the loss and every gradient leaf bitwise
  equal (fp32 and bf16 compute): the recompute runs the same operations on
  the same inputs;
* with ``remat`` on (the default, as the reference's), the loss and the
  gradients against the reference's ``jax.grad(loss_fn)``, which
  checkpoints its layers too: the loss to 1e-6 relative and each leaf to
  1e-5 of its max|grad| (MoE: 1e-5 and 1e-4), the tolerances of the
  tensor-parallel parity tests;
* what autograd keeps: counted by a ``saved_tensors_hooks`` pack hook over
  the forward, one more layer adds exactly one saved tensor under
  ``remat``, the residual entering the layer (its shape and dtype), and
  many more without it; after a step nothing of it is left alive;
* on one ``gloo`` world of four ranks (``data=2,model=2``, every arch
  tensor-parallel), each rank's gradients (summed over ``model`` where
  partial, averaged over ``data``) with ``remat`` bitwise those without,
  and the traced ``'tp'`` bytes equal to ``plan.tp_bytes`` with and
  without the recompute, to the byte.
"""

import dataclasses
import socket
import traceback
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from repro.configs import get_config as j_get_config
from repro.models.model import init_params as j_init_params
from repro.models.model import loss_fn as j_loss_fn
from repro_torch import interop
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.distributed import tp_bytes
from repro_torch.launch.mesh import parse_mesh_spec
from repro_torch.models.transformer import init_params
from repro_torch.training.train_step import loss_and_grads

ARCHS = ("muonbp-960m", "gemma2-9b", "olmoe-1b-7b", "mamba2-1.3b", "hymba-1.5b",
         "internvl2-1b", "whisper-small")
B, S = 2, 16
# The tensor-parallel parity tests' tolerances: the loss relative, each
# gradient leaf max abs over its max|grad| (tests/test_torch_tensor_parallel.py,
# test_torch_ssm_tensor_parallel.py; MoE: test_torch_moe_tensor_parallel.py).
LOSS_TOL, GRAD_TOL = 1e-6, 1e-5
MOE_LOSS_TOL, MOE_GRAD_TOL = 1e-5, 1e-4
MESH = "data=2,model=2"
WORLD_SIZE = 4


def _batch(cfg, seed=0, rows=B, seq=S) -> dict:
    """Tokens, next-token labels and the arch's N(0, 0.1^2) stub inputs."""
    r = np.random.default_rng(seed)
    tokens = r.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32)
    out = {"tokens": tokens,
           "labels": np.concatenate([tokens[:, 1:], -np.ones((rows, 1), np.int32)], axis=1)}
    if cfg.arch_type == "vlm":
        out["vision_embeds"] = (0.1 * r.standard_normal(
            (rows, cfg.vision_tokens, cfg.d_model))).astype(np.float32)
    if cfg.arch_type == "audio":
        out["audio_frames"] = (0.1 * r.standard_normal(
            (rows, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return out


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype.kind in "iu" else torch.from_numpy(v)
            for k, v in batch.items()}


def _leaves(tree) -> dict:
    return dict(tree_lib.flatten_with_path(tree))


# ---------------------------------------------------------------------------
# One process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cases():
    """Per arch, once: (port cfg, the reference's params on the CPU, the
    batch, the reference's loss and gradients as numpy by path)."""
    cache: dict = {}

    def get(name):
        if name not in cache:
            jcfg = j_get_config(name).reduced()
            jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
            batch = _batch(jcfg, seed=1)
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            (loss, _), grads = jax.jit(jax.value_and_grad(
                lambda p, b: j_loss_fn(p, b, jcfg), has_aux=True))(jparams, jb)
            params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
            cache[name] = (get_config(name).reduced(), params, batch, float(loss),
                           {k: np.asarray(v) for k, v in _leaves(grads).items()})
        return cache[name]

    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_remat_on_and_off_are_bitwise(name, dtype, cases):
    cfg, params, batch, _, _ = cases(name)
    compute = getattr(torch, dtype)
    on = loss_and_grads(params, _t(batch), cfg, compute, remat=True)
    off = loss_and_grads(params, _t(batch), cfg, compute, remat=False)
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(on[1][k], off[1][k]) for k in on[1])
    g_on, g_off = _leaves(on[2]), _leaves(off[2])
    assert g_on.keys() == g_off.keys()
    for k in g_on:
        assert torch.equal(g_on[k], g_off[k]), k


@pytest.mark.parametrize("name", ARCHS)
def test_remat_matches_reference_grad(name, cases):
    cfg, params, batch, ref_loss, ref_grads = cases(name)
    loss_tol, grad_tol = (MOE_LOSS_TOL, MOE_GRAD_TOL) if cfg.num_experts else (LOSS_TOL,
                                                                                GRAD_TOL)
    loss, _, grads = loss_and_grads(params, _t(batch), cfg, torch.float32)
    assert abs(float(loss) - ref_loss) <= loss_tol * abs(ref_loss)
    grads = _leaves(grads)
    assert grads.keys() == ref_grads.keys()
    for k, r in ref_grads.items():
        err = float(np.abs(grads[k].numpy() - r).max())
        scale = float(np.abs(r).max())
        assert err <= grad_tol * scale or err == scale == 0.0, (k, err, scale)


def _saved(cfg, params, batch, remat: bool) -> list:
    """(shape, dtype) of every tensor autograd keeps over the forward and
    the loss (a ``saved_tensors_hooks`` pack hook; a checkpointed layer's
    own hooks keep its inner tensors from it)."""
    from repro_torch.models.model import loss_fn

    packed = []

    def pack(t):
        packed.append((tuple(t.shape), t.dtype))
        return t

    leaves = {k: p.detach().requires_grad_(True) for k, p in _leaves(params).items()}
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss_fn(tree_lib.unflatten(list(leaves.items())), _t(batch), cfg, remat=remat)
    return packed


@pytest.mark.parametrize("name", ARCHS)
def test_layer_stack_saves_one_residual_a_layer(name, cases):
    """One layer more keeps one tensor more under remat: the residual
    entering it, (B, S', D) in the compute dtype; without remat, the
    layer's activations."""
    cfg, _, batch, _, _ = cases(name)
    counts = {}
    for layers in (2, 3):
        c = dataclasses.replace(cfg, num_layers=layers)
        params = init_params(c, seed=0, device="cpu")
        counts[layers] = {remat: _saved(c, params, batch, remat) for remat in (True, False)}
    with_remat = counts[2][True]
    extra = list(counts[3][True])
    for item in with_remat:
        extra.remove(item)
    residual = (B, S + cfg.vision_tokens, cfg.d_model)
    assert extra == [(residual, torch.float32)], extra
    assert len(counts[3][False]) - len(counts[2][False]) > 4
    assert len(counts[2][True]) < len(counts[2][False])


@pytest.mark.parametrize("name", ARCHS)
def test_remat_leaves_nothing_alive_after_a_step(name, cases):
    """After a step's forward and backward are dropped, no tensor of it is
    left: the recompute's tensors and graph go with the step (a saved-tensor
    hook that held them would keep the whole step's graph alive through
    autograd, where Python's collector cannot see the cycle)."""
    import gc

    cfg, params, batch, _, _ = cases(name)

    def live() -> int:
        with warnings.catch_warnings():
            # Touching a deprecated torch.distributed alias warns.
            warnings.simplefilter("ignore", FutureWarning)
            return sum(1 for o in gc.get_objects() if isinstance(o, torch.Tensor))

    counts = []
    for _ in range(3):
        out = loss_and_grads(params, _t(batch), cfg, torch.float32)
        del out
        gc.collect()
        counts.append(live())
    assert counts[0] == counts[1] == counts[2], counts


# ---------------------------------------------------------------------------
# A gloo world: data=2,model=2, every arch tensor-parallel
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, port, queue):
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=WORLD_SIZE)
        try:
            out = {name: _rank_arch(name) for name in ARCHS}
            dist.barrier()
        finally:
            dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))


def _rank_arch(name) -> dict:
    """This rank's reduced gradients with and without remat (equal?), and
    the 'tp' bytes of each."""
    from repro_torch.distributed import make_engine
    from repro_torch.launch.mesh import make_mesh_from_spec
    from repro_torch.sharding import specs as sh
    from repro_torch.training.train_step import reduce_grads

    cfg = get_config(name).reduced()
    mesh = make_mesh_from_spec(MESH)
    full = init_params(cfg, seed=0, device="cpu")
    engine = make_engine(full, sh.param_specs(full, cfg, mesh), mesh)
    params = tree_lib.map_with_path(lambda k, p: engine.cut(p, engine.pspec_by_path[k]), full)
    comm = engine.comm
    data = sh.data_axes_for(engine.axis_sizes)
    rows = B * 2 // comm.size(data)
    batch = _batch(cfg, seed=2, rows=B * 2)
    i = comm.index(data)
    batch = _t({k: v[i * rows:(i + 1) * rows] for k, v in batch.items()})
    ctx = sh.make_ctx(cfg, engine, seq=sh.residual_len(cfg, S))
    out = {}
    for remat in (True, False):
        comm.trace.step = remat
        loss, metrics, grads = loss_and_grads(params, batch, cfg, torch.float32, ctx=ctx,
                                              remat=remat)
        # The partial gradients' sum over 'model', as the step runs it.
        out[remat] = (*reduce_grads(engine, loss, metrics, grads, ctx), grads)
    (l_on, _, g_on), (l_off, _, g_off) = out[True], out[False]
    g_on, g_off = _leaves(g_on), _leaves(g_off)
    return {"equal": bool(torch.equal(l_on, l_off)) and g_on.keys() == g_off.keys()
            and all(torch.equal(g_on[k], g_off[k]) for k in g_on),
            "tp": {remat: comm.trace.total_bytes("tp", step=remat) for remat in (True, False)},
            "phases": {e.phase for e in comm.trace.events}, "rows": rows}


@pytest.fixture(scope="module")
def world():
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = mp.start_processes(_rank_main, args=(_free_port(), queue), nprocs=WORLD_SIZE,
                               start_method="spawn", join=False)
    results = dict(queue.get(timeout=600) for _ in range(WORLD_SIZE))
    procs.join()
    for rank, res in results.items():
        assert "error" not in res, f"rank {rank} failed:\n{res['error']}"
    return results


@pytest.mark.parametrize("name", ARCHS)
def test_mesh_gradients_with_remat_equal_without(name, world):
    for rank, res in world.items():
        assert res[name]["equal"], (name, rank)


@pytest.mark.parametrize("name", ARCHS)
def test_mesh_tp_bytes_count_the_recompute(name, world):
    cfg = get_config(name).reduced()
    sizes = dict(zip(*parse_mesh_spec(MESH)))
    for res in world.values():
        got = res[name]
        assert got["phases"] == {"tp", "grad_reduce"}
        for remat in (True, False):
            assert got["tp"][remat] == tp_bytes(cfg, got["rows"], S, sizes, compute_bytes=4,
                                                remat=remat), (name, remat)
        assert got["tp"][True] > got["tp"][False]
