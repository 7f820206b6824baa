"""The port's serving engine, paged KV pool and serve_sim against the JAX package's.

Four levels, as in the reference's ``tests/test_serving_engine.py``:

* unit -- ``BlockPool`` run side by side with the reference's on one
  alloc/free script; ``PagedKVCache`` pools equal to the reference's after
  ``write_prefill``, a ``release`` scrub and ``poison``;
* engine -- the port's engine and the reference's on the same seeded
  scenarios (a queued trace, ``slow_step``, ``corrupt_cache``, rejections,
  deadlines, shedding, health hysteresis, drain): the same finished
  requests with the same tokens, the same event stream with ``ts`` and the
  spans' ``dur_s`` left out, the same counters;
* decode -- one batched decode with slots at different positions and an
  inactive slot against the reference's vmapped one; sampling held to
  determinism, co-batch independence and its law (JAX's random bits cannot
  be matched);
* chaos (subprocess) -- ``kill_in_decode`` SIGKILLs ``serve_sim`` and the
  trail holds every record stdout saw; ``obs_report``'s serving section
  equals the reference's on the same records, and a seeded ``serve_sim``
  run gives the reference's event stream.

Both packages start from the reference's parameters (``interop``). Greedy
tokens are compared exactly; pools in bf16 to one bf16 ulp (2**-7
relative), where the fresh K/V, computed in fp32 in two summation orders,
are cast.
"""

import dataclasses
import importlib.util
import json
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from conftest import tiny_cfg
from repro.models.model import init_params as j_init_params
from repro.obs.bus import Bus as JBus
from repro.obs.bus import MemorySink as JMemorySink
from repro.serving import BlockPool as JBlockPool
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import KVCacheError as JKVCacheError
from repro.serving import PagedKVCache as JPagedKVCache
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.training.faults import FaultPlan as JFaultPlan
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.obs.bus import Bus, MemorySink, read_jsonl
from repro_torch.scripts import obs_report, serve_sim
from repro_torch.scripts.chaos_run import telemetry_failures
from repro_torch.serving import (
    BlockPool,
    EngineConfig,
    KVCacheError,
    PagedKVCache,
    Request,
    ServingEngine,
)
from repro_torch.serving.kvcache import blocks_for
from repro_torch.serving.serve_step import generate, sample
from repro_torch.training.faults import FaultPlan

REPO = pathlib.Path(__file__).resolve().parents[1]
BF16_RTOL = 2.0 ** -7  # one bf16 ulp: 2**-8 to 2**-7 of the value

JAX_SIDE = types.SimpleNamespace(EngineConfig=JEngineConfig, Request=JRequest,
                                 ServingEngine=JServingEngine, Bus=JBus,
                                 MemorySink=JMemorySink, FaultPlan=JFaultPlan)
PORT_SIDE = types.SimpleNamespace(EngineConfig=EngineConfig, Request=Request,
                                  ServingEngine=ServingEngine, Bus=Bus,
                                  MemorySink=MemorySink, FaultPlan=FaultPlan)


def _load_reference_script(name):
    spec = importlib.util.spec_from_file_location(f"ref_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# Unit: block pool, config, paged storage
# ---------------------------------------------------------------------------

def test_blocks_for_is_ceil_division():
    assert [blocks_for(n, 4) for n in (0, 1, 4, 5)] == [0, 1, 1, 2]
    with pytest.raises(ValueError):
        blocks_for(-1, 4)


def test_block_pool_runs_the_reference_script_alike():
    """One alloc/free script on both pools: the same ids (LIFO reuse), the
    same stats at every step, the same errors."""
    pools = (JBlockPool(num_blocks=8, block_size=4), BlockPool(num_blocks=8, block_size=4))
    script = [("alloc", 3, "r0"), ("alloc", 2, "r1"), ("free", 0, "r0"), ("alloc", 2, "r2"),
              ("free", 1, "r1"), ("alloc", 4, "r3"), ("free", 2, "r2"), ("free", 3, "r3")]
    got = ([], [])
    for side, pool in enumerate(pools):
        ids = []
        for op, arg, owner in script:
            if op == "alloc":
                ids.append(pool.alloc(arg, owner))
                got[side].append(ids[-1])
            else:
                pool.free(ids[arg], owner)
            got[side].append(dataclasses.astuple(pool.stats()))
    assert got[0] == got[1]
    for pool in pools:
        assert pool.outstanding == 0 and pool.stats().allocs == pool.stats().frees == 11


def test_block_pool_misuse_is_an_error():
    pool = BlockPool(num_blocks=4, block_size=4)
    ids = pool.alloc(2, "r0")
    assert pool.owner_of(ids[0]) == "r0"
    with pytest.raises(KVCacheError):       # over-allocation
        pool.alloc(3, "r1")
    with pytest.raises(KVCacheError):       # foreign free
        pool.free(ids, "r1")
    pool.free(ids, "r0")
    with pytest.raises(KVCacheError):       # double free
        pool.free(ids, "r0")
    with pytest.raises(KVCacheError):
        pool.alloc(0, "r2")
    assert pool.can_alloc(4) and not pool.can_alloc(5)
    with pytest.raises(ValueError):
        BlockPool(num_blocks=0, block_size=4)


def test_engine_config_validation():
    for bad in (dict(slots=0), dict(max_model_len=8, block_size=16),
                dict(max_prompt_len=64, max_model_len=64), dict(degrade_at=0.9, shed_at=0.5)):
        with pytest.raises(ValueError):
            EngineConfig(**bad).validate()
    EngineConfig().validate()


def _pool_np(t):
    return (np.asarray(t.astype(jnp.float32)) if isinstance(t, jax.Array)
            else t.to(torch.float32).numpy())


def test_paged_kv_cache_matches_reference():
    """write_prefill (a ragged last block), poison and the release scrub give
    the reference's pools and tables; an unassigned slot cannot be poisoned."""
    cfg = get_config("granite-8b").reduced()
    L, H, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    kw = dict(slots=2, num_blocks=6, block_size=4, max_blocks_per_slot=3)
    ref, port = JPagedKVCache(cfg, **kw), PagedKVCache(cfg, device="cpu", **kw)
    assert port.window == ref.window == 12 and port.scratch == ref.scratch == 6
    assert port.k.shape == ref.k.shape and port.k.dtype == torch.bfloat16
    rng = np.random.default_rng(0)
    k, v = (rng.standard_normal((L, 10, H, Dh)).astype(np.float32) for _ in range(2))
    steps = []
    for c, arr, error in ((ref, jnp.asarray, JKVCacheError),
                          (port, torch.from_numpy, KVCacheError)):
        blocks = c.pool.alloc(3, "r0")
        c.write_prefill(1, blocks, arr(k), arr(v))
        after_write = (_pool_np(c.k), _pool_np(c.v), c.tables.copy())
        poisoned = c.poison(1)
        after_poison = (_pool_np(c.k), c.tables.copy(), poisoned)
        c.release(1, blocks, "r0")
        after_release = (_pool_np(c.k), _pool_np(c.v), c.tables.copy(), c.pool.outstanding)
        steps.append((after_write, after_poison, after_release))
        with pytest.raises(error, match="no blocks to poison"):
            c.poison(0)
    for a, b in zip(*steps):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert np.isnan(steps[1][1][0]).any() and not steps[1][2][0].any()
    with pytest.raises(KVCacheError, match="needs 3 blocks"):
        port.write_prefill(0, port.pool.alloc(2, "r1"), torch.from_numpy(k), torch.from_numpy(v))


# ---------------------------------------------------------------------------
# Engine scenarios, each driven alike on both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """{case: (reference cfg, reference params, port cfg, port params)}."""
    out = {}
    for case, over in (("granite-8b", {}), ("gemma2-9b/window4", {"window_size": 4})):
        name = case.split("/")[0]
        jcfg = tiny_cfg(name, **over)
        jp = j_init_params(jax.random.PRNGKey(0), jcfg)
        cfg = dataclasses.replace(get_config(name).reduced(), **over)
        out[case] = (jcfg, jp, cfg,
                     interop.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))
    return out


def _engine(side, models, case="granite-8b", plan=None, **over):
    jcfg, jp, cfg, p = models[case]
    ecfg = side.EngineConfig(**{
        "slots": 2, "queue_capacity": 4, "block_size": 4, "num_blocks": 24,
        "max_model_len": 32, "max_prompt_len": 16, "max_new_tokens": 8, **over})
    bus = side.Bus([side.MemorySink()])
    params, c = (jp, jcfg) if side is JAX_SIDE else (p, cfg)
    eng = side.ServingEngine(params, c, ecfg, bus=bus,
                             fault_plan=side.FaultPlan.parse(plan) if plan else None)
    return eng, bus


def _prompts(n, plen=8, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=plen).astype(np.int32) for _ in range(n)]


def _run_to_idle(eng, t0=0.0, limit=200):
    t = t0
    while not eng.idle and t < t0 + limit:
        eng.step(t)
        t += 1.0
    assert eng.idle, "engine did not drain"
    return t


def scenario_trace(side, models, case):
    """Three requests of 8-10 tokens on two slots: one waits for a slot."""
    eng, bus = _engine(side, models, case)
    for i, p in enumerate(_prompts(3)):
        assert eng.submit(side.Request(rid=f"r{i}", prompt=p[:8 + i], max_new_tokens=8), 0.0)
    _run_to_idle(eng)
    return eng, bus


def scenario_slow_step(side, models, case):
    eng, bus = _engine(side, models, case, plan="slow_step@2x0.001")
    for i, p in enumerate(_prompts(2)):
        assert eng.submit(side.Request(rid=f"f{i}", prompt=p, max_new_tokens=8), 0.0)
    _run_to_idle(eng)
    assert bus.counters["serve.slow_steps"] == 1
    return eng, bus


def scenario_corrupt_cache(side, models, case):
    eng, bus = _engine(side, models, case, plan="corrupt_cache@1")
    for i, p in enumerate(_prompts(2)):
        assert eng.submit(side.Request(rid=f"f{i}", prompt=p, max_new_tokens=8), 0.0)
    _run_to_idle(eng)
    by_rid = {r.rid: r for r in eng.finished}
    assert (by_rid["f0"].state, by_rid["f0"].reason) == ("cancelled", "corrupt")
    assert by_rid["f1"].state == "done" and bus.counters["serve.corrupt_faults"] == 1
    return eng, bus


def scenario_rejections(side, models, case):
    eng, bus = _engine(side, models, case)
    p8 = _prompts(1)[0]
    R = side.Request
    assert not eng.submit(R(rid="long", prompt=np.zeros(17, np.int32), max_new_tokens=4), 0.0)
    assert not eng.submit(R(rid="empty", prompt=p8, max_new_tokens=0), 0.0)
    small, _ = _engine(side, models, case, num_blocks=2)
    assert not small.submit(R(rid="big", prompt=p8, max_new_tokens=8), 0.0)
    assert small.finished[0].reason == "infeasible"
    for i in range(4):
        assert eng.submit(R(rid=f"q{i}", prompt=p8, max_new_tokens=999), 0.0)
    assert eng.queue[0].budget == 8  # clamped to max_new_tokens
    assert not eng.submit(R(rid="late", prompt=p8, max_new_tokens=4), 0.0)
    eng.begin_drain(0.0)
    assert not eng.submit(R(rid="after", prompt=p8, max_new_tokens=4), 0.0)
    return eng, bus


def scenario_deadlines(side, models, case):
    """Expiry mid-decode (slot and blocks reclaimed and reused), and expiry
    in the queue before any prefill."""
    eng, bus = _engine(side, models, case, slots=1)
    p = _prompts(1)[0]
    req = side.Request(rid="dl", prompt=p, max_new_tokens=8, deadline=3.0)
    assert eng.submit(req, 0.0)
    queued = side.Request(rid="q", prompt=p, max_new_tokens=4, deadline=1.5)
    assert eng.submit(queued, 0.0)
    for t in (0.0, 1.0, 2.0, 3.0):
        eng.step(t)
    assert (req.state, req.reason, req.slot, req.blocks) == ("cancelled", "deadline", None, ())
    assert queued.reason == "deadline" and eng.outstanding_blocks() == 0
    assert eng.submit(side.Request(rid="next", prompt=p, max_new_tokens=2), 4.0)
    _run_to_idle(eng, t0=4.0)
    return eng, bus


def scenario_shedding(side, models, case):
    """Overload through step() (shed to the degrade watermark, lowest
    priority and latest deadline first), then the victim order directly."""
    eng, bus = _engine(side, models, case, queue_capacity=8)
    p = _prompts(1)[0]
    for i in range(8):
        assert eng.submit(side.Request(rid=f"o{i}", prompt=p, max_new_tokens=4, priority=i % 3,
                                       deadline=None if i % 2 else 50.0 + i), 0.0)
    eng.step(0.0)
    assert eng.health == "shedding"
    _run_to_idle(eng, t0=1.0)
    specs = [("lo_late", 0, None), ("lo_soon", 0, 5.0), ("hi_late", 1, None), ("hi_soon", 1, 5.0)]
    for rid, prio, dl in specs:
        assert eng.submit(side.Request(rid=rid, prompt=p, max_new_tokens=4, priority=prio,
                                       deadline=dl), 100.0)
    order = [eng._shed_one("overload", 101.0).rid for _ in range(3)]
    assert order == ["lo_late", "lo_soon", "hi_late"]
    return eng, bus


def scenario_health(side, models, case):
    """Escalation jumps to the target at once; recovery steps down one level
    a call; degraded narrows the admission limits."""
    eng, bus = _engine(side, models, case)
    p = _prompts(1)[0]
    for i in range(4):
        eng.submit(side.Request(rid=f"h{i}", prompt=p, max_new_tokens=4), 0.0)
    eng._update_health()
    assert eng.health == "shedding"
    eng.queue.clear()
    eng._update_health()
    assert eng.health == "degraded"
    r1 = side.Request(rid="r1", prompt=np.zeros(9, np.int32), max_new_tokens=4)
    r2 = side.Request(rid="r2", prompt=np.zeros(8, np.int32), max_new_tokens=8)
    assert not eng.submit(r1, 0.0) and eng.submit(r2, 0.0) and r2.budget == 4
    eng.queue.clear()
    eng._update_health()
    assert eng.health == "healthy"
    return eng, bus


def scenario_drain(side, models, case):
    eng, bus = _engine(side, models, case, slots=1)
    p = _prompts(1)[0]
    for i in range(3):
        assert eng.submit(side.Request(rid=f"d{i}", prompt=p, max_new_tokens=4), 0.0)
    eng.step(0.0)
    eng.begin_drain(1.0)
    _run_to_idle(eng, t0=1.0)
    d0 = next(r for r in eng.finished if r.rid == "d0")
    assert d0.state == "done" and len(d0.tokens) == 4
    return eng, bus


SCENARIOS = {
    "trace": scenario_trace, "slow_step": scenario_slow_step,
    "corrupt_cache": scenario_corrupt_cache, "rejections": scenario_rejections,
    "deadlines": scenario_deadlines, "shedding": scenario_shedding,
    "health": scenario_health, "drain": scenario_drain,
}


def _stream(bus):
    def keep(r, k):
        return k != "ts" and not (k == "dur_s" and r.get("event") == "span")

    return [{k: v for k, v in r.items() if keep(r, k)} for r in bus.sinks[0].records]


@pytest.mark.parametrize("case,scenario",
                         [("granite-8b", s) for s in SCENARIOS] + [("gemma2-9b/window4", "trace")])
def test_engine_matches_reference_engine(models, case, scenario):
    """Same finished requests (state, reason, tokens, times), the same event
    stream without ts and span dur_s, the same counters; every block back."""
    runs = [SCENARIOS[scenario](side, models, case) for side in (JAX_SIDE, PORT_SIDE)]
    (j_eng, j_bus), (eng, bus) = runs
    summary = lambda e: [(r.rid, r.state, r.reason, list(map(int, r.tokens)), r.budget,
                          r.admit_t, r.first_token_t, r.finish_t) for r in e.finished]
    assert summary(eng) == summary(j_eng)
    assert _stream(bus) == _stream(j_bus)
    assert dict(bus.counters) == dict(j_bus.counters)
    assert eng.outstanding_blocks() == j_eng.outstanding_blocks()
    if eng.idle:
        assert eng.outstanding_blocks() == 0 and (eng.kv.tables == eng.kv.scratch).all()


def test_engine_tokens_equal_generate(models):
    """The batched, paged decode is token for token the dense generate loop."""
    _, _, cfg, params = models["gemma2-9b/window4"]
    prompts = _prompts(3, plen=10)
    eng, _ = _engine(PORT_SIDE, models, "gemma2-9b/window4")
    for i, p in enumerate(prompts):
        assert eng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=8), 0.0)
    _run_to_idle(eng)
    expect = generate(params, torch.from_numpy(np.stack(prompts)).long(), cfg, max_new_tokens=8,
                      max_len=eng.kv.window)
    done = sorted(eng.finished, key=lambda r: r.rid)
    assert [r.tokens for r in done] == expect.tolist()


def test_batched_decode_at_different_positions_matches_reference(models):
    """Three slots: two active at positions 11 and 13 (in their third and
    fourth blocks of 4), one inactive. One decode step on each package
    from the same state: the same tokens and finiteness, the pools equal to
    one bf16 ulp, the inactive slot's token in the scratch block at
    position 0."""
    engines = []
    for side in (JAX_SIDE, PORT_SIDE):
        eng, _ = _engine(side, models, slots=3)
        for rid, plen in (("a", 11), ("b", 13)):
            assert eng.submit(side.Request(rid=rid, prompt=_prompts(1, plen, seed=plen)[0],
                                           max_new_tokens=8), 0.0)
        eng._admit(0.0)
        engines.append(eng)
    j_eng, eng = engines
    np.testing.assert_array_equal(eng.kv.tables, j_eng.kv.tables)
    np.testing.assert_array_equal(eng._pos, [11, 13, 0])
    np.testing.assert_array_equal(eng._active, [True, True, False])
    np.testing.assert_array_equal(eng._tokens, j_eng._tokens)
    np.testing.assert_allclose(_pool_np(eng.kv.k), _pool_np(j_eng.kv.k), rtol=BF16_RTOL)

    nts, j_k, j_v, finite = j_eng._decode(
        j_eng.kv.k, j_eng.kv.v, jnp.asarray(j_eng.kv.tables), jnp.asarray(j_eng._tokens),
        jnp.asarray(j_eng._pos), jnp.asarray(j_eng._active), j_eng._step_rngs())
    p_nts, p_finite = eng._decode_fn(eng.kv.tables, eng._tokens, eng._pos, eng._active, None)
    np.testing.assert_array_equal(p_nts, np.asarray(nts))
    np.testing.assert_array_equal(p_finite, np.asarray(finite))
    for port_pool, ref_pool in ((eng.kv.k, j_k), (eng.kv.v, j_v)):
        np.testing.assert_allclose(_pool_np(port_pool), _pool_np(ref_pool), rtol=BF16_RTOL,
                                   atol=1e-6)
        assert _pool_np(port_pool)[:, eng.kv.scratch, 0].any()


# ---------------------------------------------------------------------------
# Sampling: determinism, co-batch independence, the law
# ---------------------------------------------------------------------------

def _sampled_tokens(models, prompts, seeds, temperature=0.8):
    eng, _ = _engine(PORT_SIDE, models, temperature=temperature)
    for i, (p, seed) in enumerate(zip(prompts, seeds)):
        assert eng.submit(Request(rid=f"s{i}", prompt=p, max_new_tokens=8, seed=seed), 0.0)
    _run_to_idle(eng)
    return {r.rid: r.tokens for r in eng.finished}


def test_sampling_is_deterministic_and_independent_of_the_co_batch(models):
    prompts = _prompts(2, seed=7)
    both = _sampled_tokens(models, prompts, seeds=(11, 12))
    assert both == _sampled_tokens(models, prompts, seeds=(11, 12))
    assert _sampled_tokens(models, prompts[:1], seeds=(11,))["s0"] == both["s0"]
    # Another seed draws another stream (the first token is the prefill's argmax).
    other = _sampled_tokens(models, prompts[:1], seeds=(99,))["s0"]
    assert other[0] == both["s0"][0] and other != both["s0"]
    _, _, cfg, params = models["granite-8b"]
    prompt = torch.from_numpy(np.stack(prompts)).long()
    runs = [generate(params, prompt, cfg, max_new_tokens=8, temperature=0.8, seed=s)
            for s in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def test_sample_draws_from_the_tempered_softmax():
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]])
    gen = torch.Generator().manual_seed(0)
    n = 20000
    draws = torch.stack([sample(logits, 0.7, gen) for _ in range(n)]).flatten()
    freq = torch.bincount(draws, minlength=4).double() / n
    expect = torch.softmax(logits[0].double() / 0.7, dim=-1)
    assert float((freq - expect).abs().max()) < 0.015  # ~4 standard errors at n = 20000
    assert int(sample(logits, 0.0, None)) == 0


# ---------------------------------------------------------------------------
# serve_sim and obs_report: the kill drill, the reference's event stream
# ---------------------------------------------------------------------------

SIM_ARGV = ["--reduced", "--device", "cpu", "--steps", "10", "--rate", "1", "--slots", "2",
            "--block-size", "4", "--num-blocks", "32", "--max-model-len", "32",
            "--max-prompt-len", "16", "--max-new-tokens", "8", "--prompt-lens", "8",
            "--new-tokens", "8", "--seed", "0"]


def _serve_sim(argv, cwd):
    # The port's process on one intra-op thread, as this one (torch_cpu).
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-m", "repro_torch.scripts.serve_sim", *argv],
                          cwd=cwd, capture_output=True, text=True, timeout=600, env=env)


def test_kill_in_decode_trail_survives_and_reports_as_the_reference(tmp_path):
    log = tmp_path / "serve.jsonl"
    proc = _serve_sim(SIM_ARGV + ["--fault-plan", "kill_in_decode@3", "--log-file", str(log)],
                      tmp_path)
    assert proc.returncode == -9, f"expected SIGKILL, rc={proc.returncode}\n{proc.stderr}"
    stdout_recs = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert any(r.get("event") == "admit" for r in stdout_recs)
    assert telemetry_failures(str(log), stdout_recs, "serve") == []
    records = read_jsonl(str(log))
    section = obs_report.serving_section(records)
    assert section[0] == "== serving ==" and any(l.startswith("decode dispatch") for l in section)
    assert section == _load_reference_script("obs_report").serving_section(records)


def test_serve_sim_gives_the_reference_event_stream(tmp_path):
    """An overloaded seeded run (bursts, deadlines, shedding, drain) on both
    packages: the events are host decisions over lengths and times, so they
    agree although the weights differ; so do the report and the serving
    section, and the exit code."""
    flags = ["--steps", "16", "--rate", "1.5", "--burst", "4:8x3", "--ttl", "0.6",
             "--slots", "2", "--block-size", "4", "--num-blocks", "24", "--max-model-len", "32",
             "--max-prompt-len", "16", "--max-new-tokens", "8", "--prompt-lens", "8,12,20",
             "--new-tokens", "4,8", "--seed", "3"]
    port = _serve_sim(["--reduced", "--device", "cpu", *flags, "--log-file",
                       str(tmp_path / "port.jsonl")], tmp_path)
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    ref = subprocess.run([sys.executable, str(REPO / "scripts" / "serve_sim.py"), *flags,
                          "--log-file", str(tmp_path / "ref.jsonl")], cwd=REPO,
                         capture_output=True, text=True, timeout=600, env=env)
    assert port.returncode == ref.returncode == 0, (port.stderr[-2000:], ref.stderr[-2000:])
    recs = [read_jsonl(str(tmp_path / f"{n}.jsonl")) for n in ("port", "ref")]
    drop = {"ts", "dur_s", "argv", "wall_s"}
    streams = [[{k: v for k, v in r.items() if k not in drop} for r in rs] for rs in recs]
    assert streams[0] == streams[1]
    kinds = {r.get("event") for r in recs[0]}
    assert {"shed", "cancel", "complete", "serve_report"} <= kinds
    assert [l for l in port.stdout.splitlines() if l.startswith("serve_sim:")] == \
        [l for l in ref.stdout.splitlines() if l.startswith("serve_sim:")]
    ref_report = _load_reference_script("obs_report")
    strip = lambda lines: [l for l in lines if not l.startswith("decode dispatch")]
    assert strip(obs_report.serving_section(recs[0])) == strip(ref_report.serving_section(recs[1]))


def test_serve_sim_refuses_to_run_without_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_sim.main(["--reduced", "--steps", "1"])
