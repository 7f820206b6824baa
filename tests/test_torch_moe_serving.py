"""MoE serving of the port against the JAX package: the engine on reduced
``olmoe-1b-7b`` and ``mixtral-8x7b``, per-slot routing, and ``serve_sim``.

The reference's engine ``vmap``s a batch-1 decode over its slots, so each
slot's MoE layers route its token alone (a capacity of its own). The
port's engine decodes the slots as rows of one batch and routes each row as
its own group (``moe_block(group_rows=True)``); ``generate`` keeps the
reference's batch-wide routing. Both packages start from the reference's
parameters (``interop``); greedy tokens, event streams (``ts`` and the
spans' ``dur_s`` left out) and counters are compared exactly.
"""

import dataclasses
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from conftest import tiny_cfg
from repro.models.model import init_params as j_init_params
from repro.obs.bus import read_jsonl as j_read_jsonl
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.obs.bus import read_jsonl
from repro_torch.serving import Request
from repro_torch.serving.serve_step import generate
from test_torch_serving import (
    JAX_SIDE,
    PORT_SIDE,
    REPO,
    SCENARIOS,
    _engine,
    _prompts,
    _run_to_idle,
    _serve_sim,
    _stream,
)

ARCHS = ["olmoe-1b-7b", "mixtral-8x7b"]
# A tight capacity: a decode step of four slots routed as one group has
# capacity ceil(4 * 2 / 4 * 0.25) = 1 an expert for 8 assignments, so it
# drops at least half of them; one slot alone (capacity 1, two distinct
# experts) drops none.
TIGHT = 0.25


def _case(name, **over):
    jcfg = tiny_cfg(name, **over)
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = dataclasses.replace(get_config(name).reduced(), **over)
    return (jcfg, jp, cfg, interop.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))


@pytest.fixture(scope="module")
def models():
    """{case: (reference cfg, reference params, port cfg, port params)}."""
    out = {name: _case(name) for name in ARCHS}
    out["olmoe-1b-7b/tight"] = _case("olmoe-1b-7b", capacity_factor=TIGHT)
    return out


@pytest.mark.parametrize("case,scenario", [(n, s) for n in ARCHS for s in
                                           ("trace", "corrupt_cache", "deadlines")]
                         + [("olmoe-1b-7b/tight", "trace")])
def test_moe_engine_matches_reference_engine(models, case, scenario):
    """Same finished requests (state, reason, tokens, times), the same event
    stream, the same counters; every block back."""
    (j_eng, j_bus), (eng, bus) = [SCENARIOS[scenario](side, models, case)
                                  for side in (JAX_SIDE, PORT_SIDE)]
    summary = lambda e: [(r.rid, r.state, r.reason, list(map(int, r.tokens)), r.budget,
                          r.admit_t, r.first_token_t, r.finish_t) for r in e.finished]
    assert summary(eng) == summary(j_eng)
    assert _stream(bus) == _stream(j_bus)
    assert dict(bus.counters) == dict(j_bus.counters)
    assert eng.outstanding_blocks() == 0


def _engine_tokens(side, models, prompts, case="olmoe-1b-7b/tight", new=8):
    eng, _ = _engine(side, models, case, slots=len(prompts), num_blocks=48, queue_capacity=16)
    for i, p in enumerate(prompts):
        assert eng.submit(side.Request(rid=f"r{i}", prompt=p, max_new_tokens=new), 0.0)
    _run_to_idle(eng)
    assert eng.outstanding_blocks() == 0 and all(r.state == "done" for r in eng.finished)
    return [list(map(int, r.tokens)) for r in sorted(eng.finished, key=lambda r: r.rid)]


def test_moe_engine_tokens_do_not_depend_on_the_co_batch(models):
    """Four requests on four slots at the tight capacity: each one's tokens
    equal its tokens alone in the engine, the reference engine's, and the
    port's generate on its prompt alone. The same prompts through generate
    as one batch of four (batch-wide routing, which drops) give other
    tokens: routing the slots as one group would fail this test."""
    _, _, cfg, params = models["olmoe-1b-7b/tight"]
    prompts = _prompts(4, plen=8, seed=21)
    together = _engine_tokens(PORT_SIDE, models, prompts)
    alone = [_engine_tokens(PORT_SIDE, models, [p])[0] for p in prompts]
    assert together == alone
    assert together == _engine_tokens(JAX_SIDE, models, prompts)
    single = [generate(params, torch.from_numpy(p).long()[None], cfg,
                       max_new_tokens=8)[0].tolist() for p in prompts]
    assert together == single
    batched = generate(params, torch.from_numpy(np.stack(prompts)).long(), cfg,
                       max_new_tokens=8).tolist()
    assert batched != together


def test_moe_batched_decode_step_routes_rows_alone(models):
    """Four slots holding one prompt: one engine decode step routes each
    slot's token alone, so all four draw the token of that slot decoding
    alone. Routed as one group, the four would pick the same two experts
    at a capacity of one, and three of them would lose both."""
    prompt = _prompts(1, plen=10, seed=22)[0]
    eng, _ = _engine(PORT_SIDE, models, "olmoe-1b-7b/tight", slots=4, queue_capacity=16,
                     num_blocks=48)
    for i in range(4):
        assert eng.submit(Request(rid=f"a{i}", prompt=prompt, max_new_tokens=4), 0.0)
    eng._admit(0.0)
    assert eng._active.all()
    both, finite = eng._decode_fn(eng.kv.tables, eng._tokens, eng._pos, eng._active, None)
    active = np.array([True, False, False, False])
    alone, _ = eng._decode_fn(eng.kv.tables, eng._tokens, eng._pos, active, None)
    assert finite.all() and both.tolist() == [alone[0]] * 4


def test_serve_sim_olmoe_gives_the_reference_event_stream(tmp_path):
    """serve_sim --arch olmoe-1b-7b on both packages: an overloaded seeded
    run (bursts, deadlines, shedding, drain); its events are host decisions
    over lengths and times, so they agree, and so do the report lines."""
    flags = ["--arch", "olmoe-1b-7b", "--steps", "12", "--rate", "1.5", "--burst", "4:8x3",
             "--ttl", "0.6", "--slots", "2", "--block-size", "4", "--num-blocks", "24",
             "--max-model-len", "32", "--max-prompt-len", "16", "--max-new-tokens", "8",
             "--prompt-lens", "8,12,20", "--new-tokens", "4,8", "--seed", "5"]
    port = _serve_sim(["--reduced", "--device", "cpu", *flags, "--log-file",
                       str(tmp_path / "port.jsonl")], tmp_path)
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    ref = subprocess.run([sys.executable, str(REPO / "scripts" / "serve_sim.py"), *flags,
                          "--log-file", str(tmp_path / "ref.jsonl")], cwd=REPO,
                         capture_output=True, text=True, timeout=600, env=env)
    assert port.returncode == ref.returncode == 0, (port.stderr[-2000:], ref.stderr[-2000:])
    drop = {"ts", "dur_s", "argv", "wall_s"}
    streams = [[{k: v for k, v in r.items() if k not in drop} for r in rs]
               for rs in (read_jsonl(str(tmp_path / "port.jsonl")),
                          j_read_jsonl(str(tmp_path / "ref.jsonl")))]
    assert streams[0] == streams[1]
    assert {"complete", "serve_report"} <= {r.get("event") for r in streams[0]}
    assert [l for l in port.stdout.splitlines() if l.startswith("serve_sim:")] == \
        [l for l in ref.stdout.splitlines() if l.startswith("serve_sim:")]
