"""Serving: batched decode step + prefill-into-buffer + simple generate loop.

Counterpart of ``repro/serving/serve_step.py`` for the dense models. The
reference's ``compiled_serve_step`` is a cache of ``jax.jit`` executables
per configuration; eager PyTorch compiles nothing, so it has no counterpart
and :func:`generate` calls :func:`serve_step` directly. Sampling draws from
a ``torch.Generator`` where the reference splits a ``jax.random`` key: the
same law, other random bits, so sampled tokens differ from the reference's
(greedy tokens do not).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import decode_step, prefill


def cache_from_prefill(prefill_cache: dict, cfg: ModelConfig, max_len: int,
                       dtype=torch.bfloat16) -> dict:
    """Pad a prefill-produced cache into a ``max_len`` decode buffer of ``dtype``."""
    k, v = prefill_cache["kv"]
    L, B, P, H, Dh = k.shape
    out = []
    for t in (k, v):
        buf = torch.zeros((L, B, max_len, H, Dh), dtype=dtype, device=t.device)
        buf[:, :, :P] = t.to(dtype)
        out.append(buf)
    return {"kv": tuple(out)}


def sample(logits: torch.Tensor, temperature: float,
           generator: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy argmax over the last axis (``temperature == 0``), else one draw
    from ``softmax(logits / temperature)`` per row with ``generator``."""
    logits = logits.to(torch.float32)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(probs.shape[:-1])


def serve_step(params: dict, cache: dict, token: torch.Tensor, pos, cfg: ModelConfig, *,
               temperature: float = 0.0, generator: Optional[torch.Generator] = None):
    """One serving step: decode + greedy/temperature sampling.

    Returns (next_token (B, 1), logits (B, 1, Vp), cache); the cache is
    written in place.
    """
    if temperature > 0.0 and generator is None:
        # Refuse to silently change semantics: sampling was requested, so
        # falling back to greedy would be a correctness bug, not a default.
        raise ValueError(
            f"serve_step: temperature={temperature} requires a generator; "
            f"pass generator= or set temperature=0.0 for greedy decoding")
    logits, cache = decode_step(params, token, cache, pos, cfg)
    return sample(logits, temperature, generator), logits, cache


@torch.no_grad()
def generate(params: dict, prompt: torch.Tensor, cfg: ModelConfig, *,
             max_new_tokens: int = 32, max_len: Optional[int] = None,
             temperature: float = 0.0, seed: int = 0) -> torch.Tensor:
    """Prefill the prompt (B, P) then decode. Returns (B, max_new_tokens) tokens.

    The first token is the prefill's argmax, as in the reference; with
    ``temperature > 0`` the rest are drawn with a generator seeded ``seed``.
    """
    bsz, plen = prompt.shape
    max_len = max_len or plen + max_new_tokens
    logits_p, pcache = prefill(params, {"tokens": prompt}, cfg)
    cache = cache_from_prefill(pcache, cfg, max_len)
    # The prefill's fp32 K/V and full-sequence logits are GBs at full width.
    del pcache
    generator = None
    if temperature > 0.0:
        generator = torch.Generator(device=prompt.device).manual_seed(seed)
    token = torch.argmax(logits_p[:, -1:, :].to(torch.float32), dim=-1)
    del logits_p
    toks = [token]
    for i in range(max_new_tokens - 1):
        token, _, cache = serve_step(params, cache, token, plen + i, cfg,
                                     temperature=temperature, generator=generator)
        toks.append(token)
    return torch.cat(toks, dim=1)
