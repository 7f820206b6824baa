"""Serving: batched decode step + prefill-into-buffer + simple generate loop.

Counterpart of ``repro/serving/serve_step.py`` for every arch; MoE layers
route a decode's whole batch as one group, as the reference's ``generate``
does. The SSM state of mamba2 and hymba passes from the prefill to the
decode cache as it is; whisper's audio is encoded once a ``generate``. The reference's ``compiled_serve_step`` is a
cache of ``jax.jit`` executables per configuration; eager PyTorch compiles
nothing, so it has no counterpart and :func:`generate` calls
:func:`serve_step` directly. Sampling draws from
a ``torch.Generator`` where the reference splits a ``jax.random`` key: the
same law, other random bits, so sampled tokens differ from the reference's
(greedy tokens do not).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import encode
from repro_torch.models.model import decode_step, prefill


def cache_from_prefill(prefill_cache: dict, cfg: ModelConfig, max_len: int,
                       dtype=torch.bfloat16) -> dict:
    """Pad a prefill-produced cache into a ``max_len`` decode buffer.

    The K/V (where the arch has attention) go into zeroed ``dtype`` buffers
    of ``max_len`` positions; the SSM state passes through as the prefill
    left it (fp32 ``h``, the conv windows in the prefill's dtype), in a
    dict of its own.
    """
    out = {}
    if "kv" in prefill_cache:
        k, v = prefill_cache["kv"]
        L, B, P, H, Dh = k.shape
        if P > max_len:
            raise ValueError(f"prefill of {P} positions does not fit max_len={max_len}")
        bufs = []
        for t in (k, v):
            buf = torch.zeros((L, B, max_len, H, Dh), dtype=dtype, device=t.device)
            buf[:, :, :P] = t.to(dtype)
            bufs.append(buf)
        out["kv"] = tuple(bufs)
    if "ssm" in prefill_cache:
        # A dict of its own: decode replaces its tensors (never writes into
        # them), so two caches from one prefill decode apart.
        out["ssm"] = dict(prefill_cache["ssm"])
    return out


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
               temperature: float = 0.0, generator: Optional[torch.Generator] = None,
               encoder_out: Optional[torch.Tensor] = None):
    """One serving step: decode + greedy/temperature sampling.

    Returns (next_token (B, 1), logits (B, 1, Vp), cache); the cache is
    written in place. ``encoder_out``: whisper's encoder output.
    """
    if temperature > 0.0 and generator is None:
        # Refuse to silently change semantics: sampling was requested, so
        # falling back to greedy would be a correctness bug, not a default.
        raise ValueError(
            f"serve_step: temperature={temperature} requires a generator; "
            f"pass generator= or set temperature=0.0 for greedy decoding")
    logits, cache = decode_step(params, token, cache, pos, cfg, encoder_out=encoder_out)
    return sample(logits, temperature, generator), logits, cache


@torch.no_grad()
def generate(params: dict, prompt: torch.Tensor, cfg: ModelConfig, *,
             max_new_tokens: int = 32, max_len: Optional[int] = None,
             batch_extras: Optional[dict] = None, temperature: float = 0.0,
             seed: int = 0) -> torch.Tensor:
    """Prefill the prompt (B, P) then decode. Returns (B, max_new_tokens) tokens.

    ``batch_extras``: the prompt's ``vision_embeds`` (a VLM's decode then
    starts at ``P + vision_tokens``, so ``max_len`` must hold them, as in
    the reference) or ``audio_frames`` (encoded once, for every step's
    cross-attention). The first token is the prefill's argmax, as in the
    reference; with ``temperature > 0`` the rest are drawn with a generator
    seeded ``seed``.
    """
    bsz, plen = prompt.shape
    max_len = max_len or plen + max_new_tokens
    batch = {"tokens": prompt, **(batch_extras or {})}
    logits_p, pcache = prefill(params, batch, cfg)
    # The reference starts from init_cache and overwrites every entry with
    # the prefill's: the same cache, without the zeroed buffers.
    cache = cache_from_prefill(pcache, cfg, max_len)
    # The prefill's fp32 K/V and full-sequence logits are GBs at full width.
    del pcache
    encoder_out = None
    if cfg.arch_type == "audio":
        encoder_out = encode(params["encoder"], batch["audio_frames"], cfg)
    generator = None
    if temperature > 0.0:
        generator = torch.Generator(device=prompt.device).manual_seed(seed)
    token = torch.argmax(logits_p[:, -1:, :].to(torch.float32), dim=-1)
    del logits_p
    toks = [token]
    pos = plen + (cfg.vision_tokens or 0)
    for i in range(max_new_tokens - 1):
        token, _, cache = serve_step(params, cache, token, pos + i, cfg,
                                     temperature=temperature, generator=generator,
                                     encoder_out=encoder_out)
        toks.append(token)
    return torch.cat(toks, dim=1)
