"""Tensor-parallel prefill and decode on multi-process ``gloo`` worlds on the CPU.

Each world runs once per module (a fixture spawns its ranks, which run
every case and hand back numpy results). A case is a reduced config, its
rows, its prompt and its decode cache's length and layout: each rank holds
its ``param_specs`` shards of the reference's weights
(``interop.shard_params``, fp32), prefills the prompt with
``model.prefill(ctx=)`` into its ``sharding.specs.cache_specs`` shard of
the cache, then takes STEPS greedy ``decode_step(ctx=)`` steps, each
token the argmax of the logits joined over the vocab.

Held against the JAX package's single-device ``prefill`` and ``decode_step``
(its ``ShardCtx`` carrying the world's head layouts, mesh-free) on the same
weights, run on each data shard's rows (the reference's MoE routes a data
shard's tokens as one group, as the port's ranks do), the prefill's cache
placed in the decode buffer (:func:`_buffer`: padded, or on a ring the
last ``T`` positions at ``p % T``):

* the prefill's and every step's logits, the rank's vocab columns, within
  1e-5 of the reference's max|logit| (fp32);
* the greedy tokens, exactly;
* each rank's cache after the prefill and after the last step, K/V and the
  SSM state, against the reference's sliced by ``cache_specs``, within 1e-5
  of the leaf's max;
* each leaf of ``init_cache(ctx=)`` and of the prefill's cache of the
  rank's ``local_cache_shapes`` (``cache_bytes`` of them), never the whole;
* the ``'tp'`` trace of the prefill and of each decode step equal to
  ``plan.tp_bytes(mode=...)`` and to ``mesh_bytes``'s fake-tensor count, to
  the byte.

This module's world is ``model=2`` ('head'; Q and K/V both 'hd' with 3 Q
heads and 1 KV head; gemma2-9b's softcaps and alternating window; mixtral
and hymba on a ring of 8 slots after a 12-token prompt; mamba2's SSM heads
split; olmoe; internvl2's vision tokens; whisper's encoder output), and the
refusals: a context without a decode layout, a whole cache, per-row
positions; and the decode layout of a mesh without a model split (rows or
a batch of one's positions over the data axes). A decode on a mesh takes its
ring from the context (``make_ctx(..., ring_cache=)``), so the ring cases
pass none to ``decode_step``. ``tests/test_torch_tp_decode_mesh.py`` runs ``model=4`` and
``data=2,model=2`` on the same harness, ``tests/test_torch_whole_decode.py``
the sub-blocks a model axis leaves whole (``model2_whole``,
``model4_whole``) and ``tests/test_torch_replicated_decode.py`` the meshes
without a model split (``data2``, ``data4_model1``), where the logits are
every vocab column and a prefill moves nothing.
"""

import dataclasses
import socket
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from repro.configs import get_config as j_get_config
from repro.models.encdec import encode as j_encode
from repro.models.model import decode_step as j_decode_step
from repro.models.model import init_params as j_init_params
from repro.models.model import prefill as j_prefill
from repro.models.transformer import ShardCtx as JShardCtx
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.distributed import tp_bytes
from repro_torch.sharding import specs as sh

LOGIT_TOL = 1e-5     # max abs over the reference's max|logit|
CACHE_TOL = 1e-5     # max abs over the leaf's max
STEPS = 6
WINDOW = 8           # the sliding windows (64 reduced) cut below the prompts
# name: (arch, overrides of its reduced config)
CONFIGS = {
    "dense": ("muonbp-960m", {}),
    "gemma": ("gemma2-9b", dict(window_size=WINDOW)),
    "qkv_hd": ("muonbp-960m", dict(num_heads=3, num_kv_heads=1)),
    "mixtral": ("mixtral-8x7b", dict(window_size=WINDOW)),
    "hymba": ("hymba-1.5b", dict(window_size=WINDOW)),
    "hymba_straddle": ("hymba-1.5b", dict(window_size=WINDOW, d_model=96)),
    "mamba2": ("mamba2-1.3b", {}),
    "olmoe": ("olmoe-1b-7b", {}),
    "vlm": ("internvl2-1b", {}),
    "whisper": ("whisper-small", {}),
    # Sub-blocks a model axis leaves whole (sharding.specs.whole_sub_blocks):
    # on model=2 a d_ff and a padded vocab of 511; on model=4 K/V heads of
    # 30 (Q 'head'), Q and K/V heads of 30 (3 Q heads), an expert d_ff of 6,
    # a d_inner of 198 (d_model 99, SSM heads of 18), whisper's heads of 30
    # with a d_ff of 510.
    "dense_mlp_whole": ("muonbp-960m", dict(d_ff=511)),
    "dense_vocab_whole": ("muonbp-960m", dict(vocab_size=511, vocab_pad_multiple=1)),
    "gemma_vocab_whole": ("gemma2-9b", dict(window_size=WINDOW, vocab_size=511,
                                            vocab_pad_multiple=1)),
    "vlm_vocab_whole": ("internvl2-1b", dict(vocab_size=511, vocab_pad_multiple=1)),
    "dense_kv_whole": ("muonbp-960m", dict(num_heads=4, num_kv_heads=2, head_dim=30)),
    "dense_attn_whole": ("muonbp-960m", dict(num_heads=3, num_kv_heads=1, head_dim=30)),
    "olmoe_experts_whole": ("olmoe-1b-7b", dict(d_ff=6)),
    "mamba2_whole": ("mamba2-1.3b", dict(d_model=99, ssm_head_dim=18)),
    "hymba_ssm_whole": ("hymba-1.5b", dict(window_size=WINDOW, d_model=99, ssm_head_dim=18)),
    "hymba_all_whole": ("hymba-1.5b", dict(window_size=WINDOW, d_model=99, ssm_head_dim=18,
                                           num_heads=3, num_kv_heads=1, head_dim=30,
                                           d_ff=510)),
    "whisper_whole": ("whisper-small", dict(num_heads=3, num_kv_heads=3, head_dim=30,
                                            d_ff=510)),
}


@dataclasses.dataclass(frozen=True)
class Case:
    """A config's rows over the mesh, its prompt's text tokens, its decode
    cache's positions (a ring's window) and layout."""
    config: str
    batch: int = 4
    prompt: int = 12
    cache_len: int = 20
    kv_seq_shard: bool = False
    ring: bool = False


# world: (mesh spec, {case name: Case}); the prompts fill past the windows.
WORLDS = {
    "model2": ("model=2", {
        "dense": Case("dense"),
        "gemma": Case("gemma"),
        "qkv_hd": Case("qkv_hd"),
        "mixtral_ring": Case("mixtral", cache_len=WINDOW, ring=True),
        "hymba_ring": Case("hymba", cache_len=WINDOW, ring=True),
        "mamba2": Case("mamba2"),
        "olmoe": Case("olmoe"),
        "vlm": Case("vlm", cache_len=36),
        "whisper": Case("whisper"),
    }),
    "model4": ("model=4", {
        "dense_kv_hd": Case("dense"),
        "dense_kv_seq": Case("dense", kv_seq_shard=True),
        "gemma_kv_seq": Case("gemma", kv_seq_shard=True),
        "mixtral_ring_kv_seq": Case("mixtral", cache_len=WINDOW, ring=True, kv_seq_shard=True),
        "hymba_straddle": Case("hymba_straddle", cache_len=WINDOW, ring=True),
        "vlm": Case("vlm", cache_len=36),
    }),
    "data2_model2": ("data=2,model=2", {
        "dense_kv_seq": Case("dense", kv_seq_shard=True),
        "dense_batch1": Case("dense", batch=1),
        "hymba_ring_batch1": Case("hymba", batch=1, cache_len=WINDOW, ring=True),
        "mamba2": Case("mamba2"),
        "olmoe": Case("olmoe"),
        "whisper": Case("whisper"),
    }),
    # Whole sub-blocks beside split ones (tests/test_torch_whole_decode.py).
    "model2_whole": ("model=2", {
        "mlp_whole": Case("dense_mlp_whole"),
        "vocab_whole": Case("dense_vocab_whole", prompt=11),
        "gemma_vocab_whole": Case("gemma_vocab_whole"),
        "vlm_vocab_whole": Case("vlm_vocab_whole", cache_len=36),
    }),
    "model4_whole": ("model=4", {
        "kv_whole": Case("dense_kv_whole"),
        "kv_whole_kv_seq": Case("dense_kv_whole", kv_seq_shard=True),
        "attn_whole": Case("dense_attn_whole", prompt=11),
        "attn_whole_kv_seq": Case("dense_attn_whole", kv_seq_shard=True),
        "olmoe_experts_whole": Case("olmoe_experts_whole"),
        "mamba2_whole": Case("mamba2_whole", prompt=11),
        "hymba_ssm_whole_ring": Case("hymba_ssm_whole", cache_len=WINDOW, ring=True),
        "hymba_all_whole_ring": Case("hymba_all_whole", cache_len=WINDOW, ring=True),
        "whisper_whole": Case("whisper_whole"),
    }),
    # Meshes without a model split (tests/test_torch_replicated_decode.py):
    # the rows over the data axes, or a batch of one with the cache's
    # sequence over them.
    "data2": ("data=2", {
        "dense_rows": Case("dense"),
        "dense_batch1": Case("dense", batch=1),
        "hymba_ring_batch1": Case("hymba", batch=1, cache_len=WINDOW, ring=True),
        "mamba2_batch1": Case("mamba2", batch=1),
        "olmoe_rows": Case("olmoe"),
        "whisper_batch1": Case("whisper", batch=1),
    }),
    "data4_model1": ("data=4,model=1", {
        "dense_rows": Case("dense"),
        "dense_batch1": Case("dense", batch=1),
        "gemma_batch1": Case("gemma", batch=1, cache_len=24),
        "vlm_batch1": Case("vlm", batch=1, cache_len=36),
        "mixtral_ring_batch1": Case("mixtral", batch=1, cache_len=WINDOW, ring=True),
    }),
}
MODULE_WORLDS = ("model2",)
REFUSAL_CASE = ("model2", "dense")


def cases_of(worlds) -> list:
    return [f"{w}:{c}" for w in worlds for c in WORLDS[w][1]]


def _cfg(name: str, get=get_config):
    """The reduced config ``name`` of CONFIGS (``get``: the port's or the JAX
    package's ``get_config``)."""
    arch, overrides = CONFIGS[name]
    return dataclasses.replace(get(arch).reduced(), **overrides)


def _sizes(world: str) -> dict:
    from repro_torch.launch.mesh import parse_mesh_spec

    return dict(zip(*parse_mesh_spec(WORLDS[world][0])))


def _shards(world: str, case: Case) -> int:
    """How many data shards split the case's rows (``batch_axes_for``)."""
    sizes = _sizes(world)
    return int(np.prod([sizes[a] for a in sh.batch_axes_for(case.batch, sizes)]))


def _inputs(cfg, case: Case) -> dict:
    """The whole batch: prompt tokens and the arch's stub inputs, from a seed."""
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (case.batch, case.prompt)).astype(np.int32)}
    if cfg.arch_type == "vlm":
        out["vision_embeds"] = (0.1 * rng.standard_normal(
            (case.batch, cfg.vision_tokens, cfg.d_model))).astype(np.float32)
    if cfg.arch_type == "audio":
        out["audio_frames"] = (0.1 * rng.standard_normal(
            (case.batch, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return out


def _buffer(t: np.ndarray, length: int, ring: bool) -> np.ndarray:
    """(L, B, S, H, hd) prefill K or V -> the decode buffer of ``length``
    positions: padded with zeros, or on a ring the last ``length``
    positions at slot ``p % length``."""
    seq = t.shape[2]
    buf = np.zeros(t.shape[:2] + (length,) + t.shape[3:], t.dtype)
    for p in range(max(0, seq - length) if ring else 0, seq):
        buf[:, :, p % length] = t[:, :, p]
    return buf


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _numpy_cache(cache: dict) -> dict:
    out = {}
    if "kv" in cache:
        out["kv"] = tuple(np.asarray(t, np.float32) if not isinstance(t, torch.Tensor)
                          else t.numpy().copy() for t in cache["kv"])
    if "ssm" in cache:
        out["ssm"] = {k: (v.numpy().copy() if isinstance(v, torch.Tensor)
                          else np.asarray(v, np.float32)) for k, v in cache["ssm"].items()}
    return out


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _rank_main(rank, world_size, port, world, params_np, queue):
    try:
        queue.put((rank, _rank_cases(rank, world_size, port, world, params_np)))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))


def _rank_cases(rank, world_size, port, world, params_np) -> dict:
    import torch.distributed as dist

    from repro_torch.distributed import tensor_parallel
    from repro_torch.distributed.audit import Collectives
    from repro_torch.launch.mesh import make_mesh_from_spec
    from repro_torch.models.encdec import encode
    from repro_torch.models.model import decode_step, init_cache, prefill

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world_size)
    out: dict = {}
    try:
        comm = Collectives(make_mesh_from_spec(WORLDS[world][0]))
        sizes = comm.axis_sizes
        out["coords"] = dict(comm.coords)
        for name, case in WORLDS[world][1].items():
            cfg = _cfg(case.config)
            params = interop.shard_params(params_np[case.config], cfg, sizes, comm.coords,
                                          device="cpu")
            baxes = sh.batch_axes_for(case.batch, sizes)
            n, i = comm.size(baxes), comm.index(baxes)
            rows = slice(i * case.batch // n, (i + 1) * case.batch // n)
            batch = {k: torch.from_numpy(v[rows]) for k, v in _inputs(cfg, case).items()}
            batch["tokens"] = batch["tokens"].long()
            start = cfg.vision_tokens + case.prompt
            ctx = sh.make_ctx(cfg, comm=comm, seq=start, batch=case.batch,
                              cache_len=case.cache_len, kv_seq_shard=case.kv_seq_shard,
                              ring_cache=case.ring)
            res = {"rows": (rows.start, rows.stop), "kv_seq_axes": ctx.kv_seq_axes,
                   "layouts": (ctx.q_layout, ctx.kv_layout),
                   "init_shapes": sh.held_cache_shapes(init_cache(
                       cfg, case.batch, case.cache_len, dtype=torch.float32, device="cpu",
                       ctx=ctx)),
                   "want_shapes": ctx.cache_shapes}

            def argmax(logits):
                comm.trace.step = (name, "argmax")
                whole = logits[:, -1:]
                if ctx.tensor_parallel and not ctx.vocab_whole:
                    whole = tensor_parallel.gather_cols(whole.contiguous(), ctx)
                return torch.argmax(whole, dim=-1)

            with torch.no_grad():
                comm.trace.step = (name, "prefill")
                logits, cache = prefill(params, batch, cfg, ctx=ctx)
                res["prefill_logits"] = logits.numpy().copy()
                res["prefill_cache"] = _numpy_cache(cache)
                res["prefill_shapes"] = sh.held_cache_shapes(cache)
                enc = None
                if cfg.arch_type == "audio":
                    comm.trace.step = (name, "encode")
                    enc = encode(params["encoder"], batch["audio_frames"], cfg, ctx)
                token = argmax(logits)
                tokens, steps = [token.numpy().copy()], []
                for t in range(STEPS):
                    comm.trace.step = (name, "decode", t)
                    lg, cache = decode_step(params, token, cache, start + t, cfg,
                                            encoder_out=enc, ctx=ctx)
                    steps.append(lg.numpy().copy())
                    token = argmax(lg)
                    tokens.append(token.numpy().copy())
            res.update(logits=steps, tokens=tokens, cache=_numpy_cache(cache))
            if (world, name) == REFUSAL_CASE:
                res["refusals"] = _refusals(comm, cfg, params, batch, ctx, case)
            out[name] = res
        out["trace"] = list(comm.trace.events)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def _refusals(comm, cfg, params, batch, ctx, case) -> dict:
    """Each layout or input the slice does not cover raises, naming it, and
    issues no collective: nothing runs replicated or on the whole cache."""
    from repro_torch.models.model import decode_step, init_cache, prefill

    out = {}
    rank_cache = init_cache(cfg, case.batch, case.cache_len, dtype=torch.float32, device="cpu",
                            ctx=ctx)
    rows = batch["tokens"].shape[0]
    token = batch["tokens"][:, :1]
    tries = {
        "whole_cache": lambda: decode_step(
            params, token, init_cache(cfg, case.batch, case.cache_len, dtype=torch.float32,
                                      device="cpu"), 12, cfg, ctx=ctx),
        "train_ctx_prefill": lambda: prefill(
            params, batch, cfg, ctx=sh.make_ctx(cfg, comm=comm, seq=case.prompt)),
        "train_ctx_decode": lambda: decode_step(
            params, token, rank_cache, 12, cfg, ctx=sh.make_ctx(cfg, comm=comm, seq=1)),
        "per_row_positions": lambda: decode_step(params, token, rank_cache,
                                                 torch.full((rows,), 12), cfg, ctx=ctx),
        "init_cache_other_len": lambda: init_cache(cfg, case.batch, case.cache_len + 4,
                                                   device="cpu", ctx=ctx),
    }
    for what, call in tries.items():
        before = len(comm.trace.events)
        try:
            with torch.no_grad():
                call()
            out[what] = "ran"
        except (ValueError, NotImplementedError) as e:
            out[what] = f"raised {type(e).__name__}" + (
                "" if len(comm.trace.events) == before else " after a collective")
    return out


def spawn_worlds(worlds, params_np) -> dict:
    """Every world of ``worlds`` at once, each on its own port; their results."""
    ctx = mp.get_context("spawn")
    started = {}
    for world in worlds:
        n = int(np.prod(list(_sizes(world).values())))
        queue = ctx.Queue()
        procs = mp.start_processes(_rank_main, args=(n, _free_port(), world, params_np, queue),
                                   nprocs=n, start_method="spawn", join=False)
        started[world] = (n, queue, procs)
    out = {}
    for world, (n, queue, procs) in started.items():
        out[world] = dict(queue.get(timeout=600) for _ in range(n))
        procs.join()
        for rank, res in out[world].items():
            assert "error" not in res, f"{world}: rank {rank} failed:\n{res['error']}"
    return out


def reference_params(worlds) -> dict:
    """The reference's weights of every config the worlds run, from one seed."""
    configs = sorted({c.config for w in worlds for c in WORLDS[w][1].values()})
    return {c: jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0),
                                                      _cfg(c, j_get_config)))
            for c in configs}


def references(worlds, params_np) -> dict:
    """The reference's single-device prefill and greedy decode of every case,
    on each data shard's rows, joined over the shards: the prefill's logits,
    each step's, the tokens, and the cache after the prefill and after the
    last step (the decode buffer's whole layout)."""
    out = {}
    jitted = {}
    for world in worlds:
        m = _sizes(world).get("model", 1)
        for name, case in WORLDS[world][1].items():
            jcfg = _cfg(case.config, j_get_config)
            cfg = _cfg(case.config)
            ql, kvl = sh.attn_layouts(cfg, m)
            jctx = JShardCtx(q_layout=ql or "head", kv_layout=kvl or "head")
            key = (case.config, ql, kvl, case.ring)
            if key not in jitted:
                jitted[key] = (
                    jax.jit(lambda p, b, jcfg=jcfg, jctx=jctx: j_prefill(p, b, jcfg, ctx=jctx)),
                    jax.jit(lambda p, tok, c, pos, enc, jcfg=jcfg, jctx=jctx, ring=case.ring:
                            j_decode_step(p, tok, c, pos, jcfg, ctx=jctx, encoder_out=enc,
                                          ring_cache=ring)))
            j_pre, j_step = jitted[key]
            params = params_np[case.config]
            inputs = _inputs(cfg, case)
            shards = _shards(world, case)
            rows = case.batch // shards
            start = cfg.vision_tokens + case.prompt
            parts = []
            for d in range(shards):
                batch = {k: jnp.asarray(v[d * rows:(d + 1) * rows]) for k, v in inputs.items()}
                logits, _, pcache = j_pre(params, batch)
                cache = {}
                if "kv" in pcache:
                    cache["kv"] = tuple(jnp.asarray(_buffer(np.asarray(t), case.cache_len,
                                                            case.ring)) for t in pcache["kv"])
                if "ssm" in pcache:
                    cache["ssm"] = pcache["ssm"]
                enc = (j_encode(params["encoder"], batch["audio_frames"], jcfg, jctx)
                       if cfg.arch_type == "audio" else None)
                part = {"prefill_logits": np.asarray(logits), "prefill_cache": _numpy_cache(cache)}
                token = jnp.argmax(logits[:, -1:], axis=-1)
                tokens, steps = [np.asarray(token)], []
                for t in range(STEPS):
                    lg, cache = j_step(params, token, cache, jnp.int32(start + t), enc)
                    steps.append(np.asarray(lg))
                    token = jnp.argmax(lg, axis=-1)
                    tokens.append(np.asarray(token))
                part.update(logits=steps, tokens=tokens, cache=_numpy_cache(cache))
                parts.append(part)
            out[f"{world}:{name}"] = {
                "prefill_logits": np.concatenate([p["prefill_logits"] for p in parts]),
                "logits": [np.concatenate(x) for x in zip(*(p["logits"] for p in parts))],
                "tokens": [np.concatenate(x) for x in zip(*(p["tokens"] for p in parts))],
                "prefill_cache": _join_caches([p["prefill_cache"] for p in parts]),
                "cache": _join_caches([p["cache"] for p in parts])}
    return out


def _join_caches(caches: list) -> dict:
    """The data shards' caches joined along their rows (dim 1)."""
    out = {}
    if "kv" in caches[0]:
        out["kv"] = tuple(np.concatenate([c["kv"][i] for c in caches], axis=1)
                          for i in range(2))
    if "ssm" in caches[0]:
        out["ssm"] = {k: np.concatenate([c["ssm"][k] for c in caches], axis=1)
                      for k in caches[0]["ssm"]}
    return out


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params_np():
    return reference_params(MODULE_WORLDS)


@pytest.fixture(scope="module")
def worlds(params_np):
    """Every world's results, the worlds spawned together, once."""
    return spawn_worlds(MODULE_WORLDS, params_np)


@pytest.fixture(scope="module")
def refs(params_np):
    return references(MODULE_WORLDS, params_np)


@pytest.fixture(scope="module", params=cases_of(MODULE_WORLDS))
def case(request):
    return request.param


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------

def _split(case_id: str) -> tuple:
    world, name = case_id.split(":")
    return world, name, WORLDS[world][1][name]


def _vocab_cols(ref: np.ndarray, world: str, coords: dict, cfg) -> np.ndarray:
    """The rank's vocab columns of whole logits (..., Vp): all of them where
    the model axis leaves the vocab whole (or there is none)."""
    sizes = _sizes(world)
    if sh.whole_sub_blocks(cfg, sizes)["vocab"] or sizes.get("model", 1) == 1:
        return ref
    cols = ref.shape[-1] // sizes["model"]
    return ref[..., coords["model"] * cols:(coords["model"] + 1) * cols]


def test_layouts_follow_cache_specs(case, worlds):
    """The context's layouts are the reference's rules: the cache's sequence
    over ``model`` only with kv_seq_shard, over the data axes when no data
    axis divides the rows, the head layouts ``attn_layouts``'."""
    world, name, c = _split(case)
    cfg = _cfg(c.config)
    sizes = _sizes(world)
    specs = sh.cache_specs(cfg, sh.decode_shape(c.batch, c.cache_len), sizes,
                           kv_seq_shard=c.kv_seq_shard, cache_len=c.cache_len)
    for res in worlds[world].values():
        r = res[name]
        want = sh.spec_entry_names(specs["kv"][0][2]) if "kv" in specs else ()
        assert r["kv_seq_axes"] == want
        assert r["layouts"] == sh.attn_layouts(cfg, sizes.get("model", 1))


def test_prefill_and_decode_logits_match_reference(case, worlds, refs):
    """The prefill's logits and every decode step's, each rank's vocab
    columns of its rows, within LOGIT_TOL of the reference's max|logit|."""
    world, name, c = _split(case)
    ref = refs[case]
    for rank, res in worlds[world].items():
        r = res[name]
        rows = slice(*r["rows"])
        pairs = [(r["prefill_logits"], ref["prefill_logits"])] + list(zip(r["logits"],
                                                                          ref["logits"]))
        for i, (got, want) in enumerate(pairs):
            want = want[rows]
            err = np.abs(got - _vocab_cols(want, world, res["coords"], _cfg(c.config))).max()
            assert err <= LOGIT_TOL * np.abs(want).max(), (rank, i, err)


def test_greedy_tokens_match_reference(case, worlds, refs):
    world, name, _ = _split(case)
    ref = refs[case]
    for res in worlds[world].values():
        r = res[name]
        rows = slice(*r["rows"])
        np.testing.assert_array_equal(np.concatenate(r["tokens"], axis=1),
                                      np.concatenate(ref["tokens"], axis=1)[rows])


def _check_cache(world: str, c: Case, got: dict, whole: dict, coords: dict, what: str):
    cfg = _cfg(c.config)
    sizes = _sizes(world)
    specs = sh.cache_specs(cfg, sh.decode_shape(c.batch, c.cache_len), sizes,
                           kv_seq_shard=c.kv_seq_shard, cache_len=c.cache_len)
    leaves = []
    if "kv" in specs:
        leaves += [(f"kv{i}", got["kv"][i], whole["kv"][i], specs["kv"][i]) for i in range(2)]
    if "ssm" in specs:
        leaves += [(k, got["ssm"][k], whole["ssm"][k], specs["ssm"][k]) for k in specs["ssm"]]
    assert leaves
    for key, shard, full, spec in leaves:
        want = full[sh.spec_slices(spec, full.shape, sizes, coords)]
        assert shard.shape == want.shape, (what, key, shard.shape, want.shape)
        err = np.abs(shard - want).max()
        assert err <= CACHE_TOL * max(np.abs(full).max(), 1e-30), (what, key, err)


def test_cache_shards_match_reference(case, worlds, refs):
    """Each rank's cache after the prefill and after the last step, K/V and
    the SSM state, against the reference's sliced by ``cache_specs``."""
    world, name, c = _split(case)
    ref = refs[case]
    for res in worlds[world].values():
        r = res[name]
        for what in ("prefill_cache", "cache"):
            _check_cache(world, c, r[what], ref[what], res["coords"], what)


def test_each_rank_holds_its_cache_specs_shard(case, worlds):
    """``init_cache(ctx=)`` and the prefill allocate each leaf at the rank's
    ``local_cache_shapes``, 1/(its shards) of the whole's bytes."""
    world, name, c = _split(case)
    cfg = _cfg(c.config)
    sizes = _sizes(world)
    want = sh.local_cache_shapes(cfg, c.batch, c.cache_len, sizes, kv_seq_shard=c.kv_seq_shard)
    specs = sh.cache_specs(cfg, sh.decode_shape(c.batch, c.cache_len), sizes,
                           kv_seq_shard=c.kv_seq_shard, cache_len=c.cache_len)
    for res in worlds[world].values():
        r = res[name]
        assert r["want_shapes"] == want
        assert r["init_shapes"] == want and r["prefill_shapes"] == want
    whole = sh.cache_bytes(sh.local_cache_shapes(cfg, c.batch, c.cache_len, {}), 4)
    parts = 0
    for leaf, spec in ([(want["kv"][i], specs["kv"][i]) for i in range(2)] if "kv" in want
                       else []):
        parts += np.prod(leaf) * 4 * np.prod([sh.spec_entry_size(e, sizes) for e in spec])
    for k, leaf in want.get("ssm", {}).items():
        parts += np.prod(leaf) * 4 * np.prod(
            [sh.spec_entry_size(e, sizes) for e in specs["ssm"][k]])
    assert parts == whole


def test_trace_equals_tp_bytes_and_mesh_bytes(case, worlds):
    """The ``'tp'`` bytes of the prefill and of each decode step equal
    ``plan.tp_bytes`` and ``mesh_bytes``'s, to the byte; every collective
    of the prefill and decode is of class ``'tp'``."""
    from repro_torch.scripts.mesh_bytes import mesh_bytes

    world, name, c = _split(case)
    cfg = _cfg(c.config)
    sizes = _sizes(world)
    kw = dict(batch=c.batch, kv_seq_shard=c.kv_seq_shard, compute_bytes=4)
    fake = mesh_bytes(cfg, sizes, batch=c.batch, seq=c.prompt, compute_bytes=4,
                      cache_len=c.cache_len, kv_seq_shard=c.kv_seq_shard)
    for res in worlds[world].values():
        r = res[name]
        rows = r["rows"][1] - r["rows"][0]
        events = res["trace"]
        pre = [e for e in events if e.step == (name, "prefill")]
        predicted = tp_bytes(cfg, rows, c.prompt, sizes, mode="prefill",
                             cache_len=c.cache_len, **kw)
        # No collective at all where every rank computes its values alike.
        assert {e.phase for e in pre} == ({"tp"} if predicted else set())
        assert sum(e.bytes for e in pre) == predicted == fake["tp_prefill"]
        step = tp_bytes(cfg, rows, c.cache_len, sizes, mode="decode", **kw)
        assert step == fake["tp_decode"]
        for t in range(STEPS):
            dec = [e for e in events if e.step == (name, "decode", t)]
            assert {e.phase for e in dec} == ({"tp"} if step else set())
            assert sum(e.bytes for e in dec) == step, t


def test_refusals_raise_and_run_nothing(worlds):
    """A context without a decode layout, a whole cache, per-row positions
    and a cache of another length raise before any collective."""
    world, name = REFUSAL_CASE
    for res in worlds[world].values():
        got = res[name]["refusals"]
        assert all(v.startswith("raised") and "collective" not in v for v in got.values()), got


class _Comm:
    """The sizes and this rank's place that a mesh's ``Collectives``
    reports, without a world."""

    def __init__(self, sizes, coords):
        self.axis_sizes, self.coords = sizes, coords

    def size(self, axes):
        return int(np.prod([self.axis_sizes.get(a, 1) for a in axes]))

    def index(self, axes):
        i = 0
        for a in axes:
            i = i * self.axis_sizes.get(a, 1) + self.coords.get(a, 0)
        return i


@pytest.mark.parametrize("spec", ["data=4,model=1", "data=2"])
def test_decode_layout_without_a_model_split(spec):
    """A decode layout on a mesh without a model split is the reference's
    ``cache_specs``: four rows over the data axes (each rank its rows,
    every position), a batch of one with the cache's sequence over them
    (each rank its positions); the context is not tensor-parallel and
    ``init_cache`` allocates the rank's shard."""
    from repro_torch.launch.mesh import parse_mesh_spec
    from repro_torch.models.model import init_cache

    sizes = dict(zip(*parse_mesh_spec(spec)))
    data = sizes["data"]
    cfg = _cfg("dense")
    for batch, seq_axes, shape in [(4, (), (4 // data, 20)), (1, ("data",), (1, 20 // data))]:
        ctx = sh.make_ctx(cfg, comm=_Comm(sizes, {"data": data - 1}), seq=12, batch=batch,
                          cache_len=20)
        assert not ctx.tensor_parallel and ctx.mesh_cache
        assert ctx.kv_seq_axes == seq_axes
        assert ctx.kv_seq_range() == ((0, 20) if not seq_axes else
                                      (20 - 20 // data, 20))
        kv = (cfg.num_layers, *shape, cfg.num_kv_heads, cfg.head_dim)
        assert ctx.cache_shapes == sh.local_cache_shapes(cfg, batch, 20, sizes) == {"kv": (kv, kv)}
        cache = init_cache(cfg, batch, 20, dtype=torch.float32, device="cpu", ctx=ctx)
        assert sh.held_cache_shapes(cache) == ctx.cache_shapes
