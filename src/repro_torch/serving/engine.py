"""Resilient continuous-batching serving engine.

Counterpart of ``repro/serving/engine.py`` for the dense and MoE models. Admission,
the health ladder, shedding, deadlines, drain and harvest are the
reference's host code as it is; events, counters and gauges are the same,
letter for letter. What differs is the decode step (see
:meth:`ServingEngine._decode_fn`) and sampling, which draws from one
``torch.Generator`` a request and step, seeded from ``(req.seed,
len(req.tokens))`` as the reference folds its key: the same law, other
random bits than ``jax.random``. Like the reference it serves the dense
and MoE archs and raises for any other.

One :class:`ServingEngine` owns a fixed set of decode *slots*, a bounded
request queue, and a block-granular paged KV pool (``kvcache.py``). Every
scheduler iteration (:meth:`ServingEngine.step`) runs the full guarded
lifecycle:

1. **expire** — queued or active requests past their deadline are cancelled
   (mid-decode cancellation reclaims the slot and its KV blocks);
2. **health** — a state machine (``healthy -> degraded -> shedding``, plus
   sticky ``draining``) driven by queue/KV pressure with hysteresis.
   ``degraded`` narrows the admission limits (max prompt length, new-token
   budget) before anything is dropped; ``shedding`` additionally sheds
   queued requests, lowest priority / latest deadline first;
3. **admit** — queued requests move into free slots when their *entire* KV
   footprint (prompt + clamped new-token budget) can be reserved from the
   block pool; prefill runs eagerly (same op sequence as the
   ``generate()`` loop) and its cache is paged into the reserved blocks.
   The first output token comes from the prefill logits — time-to-first-token
   is the admission step;
4. **decode** — one token for every active slot in one batched step: each
   layer writes every slot's fresh K/V into its pool block in place, then
   gathers each slot's block table into a static-shape window, and attends
   from the slot's own position. A per-slot logit-finiteness guard cancels
   poisoned requests (``corrupt_cache`` faults, reason ``corrupt``) without
   touching co-batched slots;
5. **harvest** — finished sequences (budget exhausted or EOS) are evicted,
   their blocks scrubbed and recycled, and a ``complete`` event carries
   TTFT / per-token latency.

Admission control is reject-with-reason, never unbounded growth: ``submit``
refuses with ``queue_full``, ``prompt_too_long``, ``infeasible`` (footprint
can never fit the pool or the per-slot window), or ``draining``. Every
admission/termination emits a structured event on the telemetry bus
(schema in ``repro_torch.obs.bus.EVENT_FIELDS``; the full list this module
emits is :data:`SERVE_EVENTS`).

The engine runs on an explicit *virtual clock*: callers pass ``now`` to
``submit``/``step``. Deadlines, TTFT, and per-token latencies are virtual —
a seeded traffic generator (``repro_torch.scripts.serve_sim``) replays
byte-identical event streams regardless of host speed. Wall time is tracked separately via
``obs.spans`` around the decode dispatch.

Faults (``repro_torch.training.faults`` grammar, e.g.
``slow_step@10x0.2,corrupt_cache@20,kill_in_decode@30``) are injected at
named points in the iteration so chaos runs replay deterministically.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import prefill
from repro_torch.models.transformer import decode_layers
from repro_torch.obs import bus as bus_lib
from repro_torch.obs.spans import span
from repro_torch.serving.kvcache import PagedKVCache, PagedLayer, blocks_for
from repro_torch.serving.serve_step import sample
from repro_torch.training import faults as faults_lib

# Event types this module emits (the schema lives in obs.bus.EVENT_FIELDS).
SERVE_EVENTS = ("admit", "reject", "shed", "cancel", "complete", "health",
                "serve_step", "serve_report")

# Health ladder, mildest first. "draining" is entered only via begin_drain()
# and is sticky — a drained engine never re-admits.
HEALTH_STATES = ("healthy", "degraded", "shedding", "draining")


@dataclasses.dataclass
class Request:
    """One generation request. Engine-owned fields are set by the engine."""

    rid: str
    prompt: np.ndarray            # (P,) int32 token ids
    max_new_tokens: int
    tenant: str = "default"
    priority: int = 0             # larger = more important; shed lowest first
    deadline: Optional[float] = None  # absolute virtual-clock seconds
    seed: int = 0                 # per-request sampling stream

    # -- engine-owned runtime state --
    state: str = "new"            # new|queued|active|done|rejected|shed|cancelled
    reason: Optional[str] = None  # terminal reason for reject/shed/cancel
    arrival_t: float = 0.0
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    tokens: list = dataclasses.field(default_factory=list)
    budget: int = 0               # effective new-token budget after clamping
    slot: Optional[int] = None
    blocks: tuple = ()

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving-engine capacity, limits, and degradation policy."""

    slots: int = 4                 # concurrent decode lanes
    queue_capacity: int = 16       # bounded admission queue
    block_size: int = 16           # KV tokens per pool block
    num_blocks: int = 64           # total KV pool budget
    max_model_len: int = 256       # per-request KV footprint cap (tokens)
    max_prompt_len: int = 128      # healthy-state admission limit
    max_new_tokens: int = 64       # healthy-state per-request budget cap
    temperature: float = 0.0
    eos_id: Optional[int] = None
    # health thresholds on pressure = max(queue fill, KV-pool fill);
    # escalation is immediate, recovery (one level per step) waits for
    # pressure <= recover_at — hysteresis so the state doesn't flap.
    degrade_at: float = 0.5
    shed_at: float = 0.875
    recover_at: float = 0.25
    # admission limits while degraded (fraction of the healthy limits)
    degraded_prompt_frac: float = 0.5
    degraded_new_frac: float = 0.5

    def validate(self) -> None:
        if self.slots <= 0 or self.queue_capacity <= 0:
            raise ValueError("slots and queue_capacity must be positive")
        if self.max_model_len < self.block_size:
            raise ValueError("max_model_len smaller than one block")
        if self.max_prompt_len + 1 > self.max_model_len:
            raise ValueError(
                f"max_prompt_len {self.max_prompt_len} + 1 token exceeds "
                f"max_model_len {self.max_model_len}")
        if not (0 < self.recover_at <= self.degrade_at <= self.shed_at <= 1):
            raise ValueError(
                "need 0 < recover_at <= degrade_at <= shed_at <= 1")


class ServingEngine:
    """Continuous batching with admission control and graceful degradation."""

    def __init__(
        self,
        params: dict,
        cfg: ModelConfig,
        ecfg: EngineConfig = EngineConfig(),
        *,
        bus: Optional[bus_lib.Bus] = None,
        fault_plan: Optional[faults_lib.FaultPlan] = None,
    ):
        """The KV pool lives on the device of ``params``."""
        if cfg.arch_type not in ("dense", "moe"):
            raise NotImplementedError(
                f"serving engine supports decoder-only KV archs (dense/moe), "
                f"got {cfg.arch_type!r}")
        ecfg.validate()
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        self.device = params["embed"].device
        self.bus = bus if bus is not None else bus_lib.get_bus()
        self.faults = fault_plan

        max_blocks = blocks_for(ecfg.max_model_len, ecfg.block_size)
        self.kv = PagedKVCache(
            cfg, slots=ecfg.slots, num_blocks=ecfg.num_blocks,
            block_size=ecfg.block_size, max_blocks_per_slot=max_blocks,
            device=self.device)

        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []   # every terminal request, in order
        self.health = "healthy"
        self.step_idx = 0                   # scheduler iterations so far
        self._slot_req: list[Optional[Request]] = [None] * ecfg.slots
        self._tokens = np.zeros(ecfg.slots, np.int32)
        self._pos = np.zeros(ecfg.slots, np.int32)
        self._active = np.zeros(ecfg.slots, bool)
        if fault_plan is not None:
            # crash_point consults the process-global plan — arm it so
            # kill_in_decode fires from inside the decode loop.
            faults_lib.set_active(fault_plan)

    # ------------------------------------------------------------------
    # Admission
    # ------------------------------------------------------------------

    def _limits(self) -> tuple[int, int]:
        """(max prompt, max new-token budget) under the current health."""
        e = self.ecfg
        if self.health in ("degraded", "shedding"):
            return (max(1, int(e.max_prompt_len * e.degraded_prompt_frac)),
                    max(1, int(e.max_new_tokens * e.degraded_new_frac)))
        return e.max_prompt_len, e.max_new_tokens

    def submit(self, req: Request, now: float) -> bool:
        """Admission control: enqueue or reject-with-reason. Never blocks,
        never grows state beyond ``queue_capacity``."""
        req.arrival_t = now
        e = self.ecfg
        if self.health == "draining":
            return self._reject(req, "draining")
        max_prompt, max_new = self._limits()
        if req.prompt_len > max_prompt:
            return self._reject(req, "prompt_too_long")
        if req.max_new_tokens <= 0:
            return self._reject(req, "empty_budget")
        req.budget = min(req.max_new_tokens, max_new)
        need = blocks_for(req.prompt_len + req.budget, e.block_size)
        if need > min(self.kv.pool.num_blocks, self.kv.max_blocks_per_slot):
            return self._reject(req, "infeasible")
        if len(self.queue) >= e.queue_capacity:
            return self._reject(req, "queue_full")
        req.state = "queued"
        self.queue.append(req)
        return True

    def _reject(self, req: Request, reason: str) -> bool:
        req.state, req.reason = "rejected", reason
        self.finished.append(req)
        self.bus.inc("serve.rejected")
        self.bus.event("reject", request=req.rid, tenant=req.tenant,
                       reason=reason)
        return False

    # ------------------------------------------------------------------
    # Health state machine + load shedding
    # ------------------------------------------------------------------

    def _pressure(self) -> float:
        e = self.ecfg
        queue_frac = len(self.queue) / e.queue_capacity
        kv_frac = self.kv.pool.outstanding / e.num_blocks
        return max(queue_frac, kv_frac)

    def _set_health(self, state: str, pressure: float) -> None:
        if state == self.health:
            return
        prev, self.health = self.health, state
        self.bus.inc(f"serve.health.{state}")
        self.bus.event("health", state=state, prev=prev,
                       pressure=round(pressure, 4),
                       queue_depth=len(self.queue),
                       blocks_free=self.kv.pool.free_blocks)

    def _update_health(self) -> None:
        if self.health == "draining":
            return
        p = self._pressure()
        e = self.ecfg
        target = ("shedding" if p >= e.shed_at
                  else "degraded" if p >= e.degrade_at
                  else "healthy")
        cur_i = HEALTH_STATES.index(self.health)
        tgt_i = HEALTH_STATES.index(target)
        if tgt_i > cur_i:
            self._set_health(target, p)          # escalate immediately
        elif tgt_i < cur_i and p <= e.recover_at:
            self._set_health(HEALTH_STATES[cur_i - 1], p)  # step down slowly

    def _shed_one(self, reason: str, now: float) -> Optional[Request]:
        """Drop the least valuable queued request: lowest priority first,
        then latest deadline (None = latest of all), then newest arrival."""
        if not self.queue:
            return None
        victim = min(
            self.queue,
            key=lambda r: (r.priority,
                           -(r.deadline if r.deadline is not None
                             else float("inf")),
                           -r.arrival_t))
        self.queue.remove(victim)
        victim.state, victim.reason, victim.finish_t = "shed", reason, now
        self.finished.append(victim)
        self.bus.inc("serve.shed")
        self.bus.event("shed", request=victim.rid, tenant=victim.tenant,
                       reason=reason)
        return victim

    def _shed_overload(self, now: float) -> None:
        # Shed back down to the degrade watermark so admission keeps
        # breathing room instead of oscillating at the cliff edge.
        e = self.ecfg
        while (self.queue
               and len(self.queue) / e.queue_capacity > e.degrade_at):
            self._shed_one("overload", now)

    # ------------------------------------------------------------------
    # Lifecycle transitions
    # ------------------------------------------------------------------

    def _cancel(self, req: Request, reason: str, now: float) -> None:
        if req.slot is not None:
            self._release_slot(req)
        req.state, req.reason, req.finish_t = "cancelled", reason, now
        self.finished.append(req)
        self.bus.inc("serve.cancelled")
        self.bus.event("cancel", request=req.rid, tenant=req.tenant,
                       reason=reason, tokens=len(req.tokens))

    def _release_slot(self, req: Request) -> None:
        s = req.slot
        self.kv.release(s, req.blocks, req.rid)
        self._slot_req[s] = None
        self._active[s] = False
        self._tokens[s] = 0
        self._pos[s] = 0
        req.slot, req.blocks = None, ()

    def _expire(self, now: float) -> None:
        for req in [r for r in self.queue
                    if r.deadline is not None and r.deadline <= now]:
            self.queue.remove(req)
            self._cancel(req, "deadline", now)
        for req in list(self._slot_req):
            if (req is not None and req.deadline is not None
                    and req.deadline <= now):
                self._cancel(req, "deadline", now)

    # ------------------------------------------------------------------
    # Admit: queue -> slot (prefill)
    # ------------------------------------------------------------------

    def _pick_admit(self) -> Optional[Request]:
        """Highest priority first, then earliest deadline, then FIFO."""
        if not self.queue:
            return None
        return max(
            self.queue,
            key=lambda r: (r.priority,
                           -(r.deadline if r.deadline is not None
                             else float("inf")),
                           -r.arrival_t))

    def _admit(self, now: float) -> None:
        e = self.ecfg
        while self.queue:
            free = [s for s, r in enumerate(self._slot_req) if r is None]
            if not free:
                break
            req = self._pick_admit()
            need = blocks_for(req.prompt_len + req.budget, e.block_size)
            if not self.kv.pool.can_alloc(need):
                break  # backpressure: head waits for blocks, nothing leaks
            self.queue.remove(req)
            slot = free[0]
            blocks = self.kv.pool.alloc(need, req.rid)
            # Eager prefill — identical op sequence to serve_step.generate,
            # so a fault-free engine run is token-identical to that loop.
            tokens = torch.as_tensor(req.prompt, dtype=torch.long, device=self.device)
            with torch.no_grad():
                logits_p, pcache = prefill(self.params, {"tokens": tokens[None]}, self.cfg)
                k, v = pcache["kv"]
                self.kv.write_prefill(slot, blocks, k[:, 0], v[:, 0])
                first = int(torch.argmax(logits_p[0, -1].to(torch.float32)))
            del logits_p, pcache, k, v
            req.state, req.slot, req.blocks = "active", slot, blocks
            req.admit_t = req.first_token_t = now
            req.tokens = [first]
            self._slot_req[slot] = req
            self._tokens[slot] = first
            self._pos[slot] = req.prompt_len
            self._active[slot] = True
            self.bus.inc("serve.admitted")
            self.bus.event("admit", request=req.rid, tenant=req.tenant,
                           blocks=need, queue_wait_s=round(now - req.arrival_t, 6),
                           queued=len(self.queue))

    # ------------------------------------------------------------------
    # Decode: one token for every active slot, one batched step
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _decode_fn(self, tables, tokens, pos, active, generators):
        """One token for every slot; returns host (next tokens, logits finite).

        The reference vmaps a batch-1 ``decode_step`` over the slots, each
        against its own gathered window. Here the slots are the batch, each
        row at its own position: per layer, each slot's fresh K/V go into
        its pool block in place (an inactive slot's into the scratch block,
        position 0), then every slot's table is gathered into its window
        and attended from its position (:class:`PagedLayer`). The window
        after the write equals the reference's window with the write, and
        the pool ends the step as the reference's scatter leaves it. MoE
        layers route each slot's token alone (``group_rows``), as the
        reference's per-slot step does: a slot's capacity is its own, so
        its tokens never depend on its co-batch.
        """
        dev = self.device
        tables = torch.as_tensor(tables, dtype=torch.long, device=dev)
        pos = torch.as_tensor(pos, dtype=torch.long, device=dev)
        active = torch.as_tensor(active, device=dev)
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)[:, None]
        logits = decode_layers(self.params, tokens, pos, self.cfg,
                               lambda i: PagedLayer(self.kv, i, tables, active),
                               group_rows=True)
        lg = logits[:, 0].to(torch.float32)
        finite = torch.isfinite(lg).all(dim=-1)
        if generators is None:
            nts = sample(lg, 0.0, None)
        else:
            nts = torch.stack([sample(lg[s], self.ecfg.temperature, g) if g is not None
                               else torch.argmax(lg[s]) for s, g in enumerate(generators)])
        return nts.cpu().numpy(), finite.cpu().numpy()

    def _step_generators(self) -> Optional[list]:
        """One generator a live slot, seeded from (req.seed, tokens so far)
        as the reference folds ``n`` into ``PRNGKey(seed)``; None when greedy."""
        if self.ecfg.temperature <= 0.0:
            return None
        gens = []
        for req in self._slot_req:
            if req is None:
                gens.append(None)
                continue
            seed = np.random.SeedSequence([req.seed, len(req.tokens)])
            gens.append(torch.Generator(device=self.device).manual_seed(
                int(seed.generate_state(1, np.uint64)[0])))
        return gens

    def _decode_active(self, now: float) -> None:
        if not self._active.any():
            return
        # Injected process kill: "inside the decode loop". Everything the
        # bus emitted up to here must already be fsync'd by the JSONL sink.
        faults_lib.crash_point("serve.decode", self.step_idx)
        fault = self.faults.serve_fault(self.step_idx) if self.faults else None
        if fault is not None and fault.kind == "slow_step":
            self.bus.inc("serve.slow_steps")
            time.sleep(fault.scale)
        if fault is not None and fault.kind == "corrupt_cache":
            victim = int(np.argmax(self._active))
            self.kv.poison(victim)
            self.bus.inc("serve.corrupt_faults")
        sync = ((lambda: torch.cuda.synchronize(self.device))
                if self.device.type == "cuda" else None)
        with span(self.bus, "serve_decode", sync=sync) as sp:
            nts, finite = self._decode_fn(
                self.kv.tables, self._tokens, self._pos, self._active,
                self._step_generators())
            sp.set(active=int(self._active.sum()))
        for s in range(self.ecfg.slots):
            req = self._slot_req[s]
            if req is None:
                continue
            if not finite[s]:
                # Guarded decode: poisoned cache -> cancel exactly this
                # request; its blocks are scrubbed on release so the NaN
                # can never reach another request's window.
                self._cancel(req, "corrupt", now)
                continue
            if len(req.tokens) < req.budget:
                req.tokens.append(int(nts[s]))
                self._tokens[s] = nts[s]
                self._pos[s] += 1

    # ------------------------------------------------------------------
    # Harvest
    # ------------------------------------------------------------------

    def _finish(self, req: Request, now: float) -> None:
        self._release_slot(req)
        req.state, req.finish_t = "done", now
        self.finished.append(req)
        n = len(req.tokens)
        # `or` would misread a legitimate first_token_t == 0.0 (virtual t=0)
        first = req.first_token_t if req.first_token_t is not None else now
        ttft = first - req.arrival_t
        tpot = ((now - req.first_token_t) / (n - 1)) if n > 1 else 0.0
        self.bus.inc("serve.completed")
        self.bus.inc("serve.tokens", n)
        self.bus.event("complete", request=req.rid, tenant=req.tenant,
                       tokens=n, ttft_s=round(ttft, 6),
                       tpot_s=round(tpot, 6),
                       e2e_s=round(now - req.arrival_t, 6))

    def _harvest(self, now: float) -> None:
        e = self.ecfg
        for req in list(self._slot_req):
            if req is None:
                continue
            done = len(req.tokens) >= req.budget
            if (e.eos_id is not None and req.tokens
                    and req.tokens[-1] == e.eos_id):
                done = True
            if done:
                self._finish(req, now)

    # ------------------------------------------------------------------
    # Scheduler iteration + drain
    # ------------------------------------------------------------------

    def step(self, now: float) -> dict:
        """One scheduler iteration at virtual time ``now``. Returns gauges."""
        self._expire(now)
        self._update_health()
        if self.health == "shedding":
            self._shed_overload(now)
        if self.health != "draining":
            self._admit(now)
        self._decode_active(now)
        self._harvest(now)
        gauges = {
            "step": self.step_idx,
            "active": int(self._active.sum()),
            "queued": len(self.queue),
            "blocks_free": self.kv.pool.free_blocks,
            "health": self.health,
        }
        self.bus.event("serve_step", **gauges)
        self.step_idx += 1
        return gauges

    def begin_drain(self, now: float) -> None:
        """Graceful shutdown: stop admitting, shed the queue, finish the
        in-flight slots (keep calling :meth:`step` until :attr:`idle`)."""
        self._set_health("draining", self._pressure())
        while self.queue:
            self._shed_one("shutdown", now)

    @property
    def idle(self) -> bool:
        return not self.queue and not self._active.any()

    def outstanding_blocks(self) -> int:
        return self.kv.pool.outstanding
