"""Decoder LM assembly, dense subset (counterpart of ``repro/models/transformer.py``).

Parameters keep the reference's stacked ``(num_layers, ...)`` layout under
the same path names (``layers/attn/wq``, ``layers/mlp/wi``,
``layers/norms/attn_norm``, ...). ``forward`` runs the train-mode (and
prefill) pass as a Python loop over the stacked layers, in place of the
reference's ``lax.scan``; ``decode_step`` runs one token through the same
loop against a KV cache, written in place. The reference's activation
checkpointing changes no numbers and is not ported: the full-width model
fits the card without it.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    DenseKV,
    attention_block,
    geglu,
    rms_norm,
    rope_frequencies,
    softcap,
    swiglu,
)

NO_WINDOW = 2**30


def _dense_init(gen: torch.Generator, shape, device, dtype, scale: float = 0.02):
    return (scale * torch.randn(shape, generator=gen, device=device, dtype=torch.float32)).to(dtype)


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda", dtype=torch.float32) -> dict:
    """Dense parameters from a seeded ``torch.Generator`` on ``device``.

    Same shapes, paths and init law (N(0, 0.02) matrices, unit norm gains)
    as the reference; the random draws differ, so parity tests carry the
    reference's own parameters over with ``repro_torch.interop``.
    """
    if cfg.arch_type != "dense":
        raise NotImplementedError(f"arch_type {cfg.arch_type!r} is not ported yet")
    gen = torch.Generator(device=device).manual_seed(seed)
    L, D, F = cfg.num_layers, cfg.d_model, cfg.d_ff
    Vp = cfg.padded_vocab
    init = lambda shape: _dense_init(gen, shape, device, dtype)
    ones = lambda shape: torch.ones(shape, device=device, dtype=dtype)
    layers = {
        "attn": {
            "wq": init((L, D, cfg.q_dim)),
            "wk": init((L, D, cfg.kv_dim)),
            "wv": init((L, D, cfg.kv_dim)),
            "wo": init((L, cfg.q_dim, D)),
        },
        "mlp": {"wi": init((L, D, F)), "wo": init((L, F, D))},
        "norms": {"attn_norm": ones((L, D)), "mlp_norm": ones((L, D))},
    }
    if cfg.mlp_act in ("swiglu", "geglu"):
        layers["mlp"]["wg"] = init((L, D, F))
    if cfg.use_post_norms:
        layers["norms"]["post_attn_norm"] = ones((L, D))
        layers["norms"]["post_mlp_norm"] = ones((L, D))
    params = {"embed": init((Vp, D)), "layers": layers, "final_norm": ones((D,))}
    if not cfg.tie_embeddings:
        params["lm_head"] = init((D, Vp))
    return params


def window_flags(cfg: ModelConfig) -> list[int]:
    """Per-layer attention window (NO_WINDOW = global)."""
    L = cfg.num_layers
    if cfg.attention_pattern == "swa":
        return [cfg.window_size] * L
    if cfg.attention_pattern == "alternating":
        return [cfg.window_size if i % 2 == 0 else NO_WINDOW for i in range(L)]
    return [NO_WINDOW] * L


def _mlp_apply(x, mlp, cfg):
    if cfg.mlp_act == "swiglu":
        return swiglu(x, mlp["wi"], mlp["wg"], mlp["wo"])
    if cfg.mlp_act == "geglu":
        return geglu(x, mlp["wi"], mlp["wg"], mlp["wo"])
    return torch.nn.functional.gelu(x @ mlp["wi"], approximate="tanh") @ mlp["wo"]


def decoder_layer(x, layer: dict, cfg: ModelConfig, *, window: int, positions, inv_freq,
                  kv_cache=None, cache_index=None):
    """One dense decoder layer (pre-norm attention + MLP, optional post norms).

    Returns ``(x, new_kv)``: the post-RoPE K/V without a cache (what prefill
    keeps), the attended cache with one (see ``layers.attention_block``).
    """
    norms = layer["norms"]
    h = rms_norm(x, norms["attn_norm"])
    attn_out, new_kv = attention_block(
        h, layer["attn"], num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, positions=positions, inv_freq=inv_freq,
        window=window, attn_softcap=cfg.attn_softcap,
        kv_cache=kv_cache, cache_index=cache_index,
    )
    if cfg.use_post_norms:
        attn_out = rms_norm(attn_out, norms["post_attn_norm"])
    x = x + attn_out
    h = rms_norm(x, norms["mlp_norm"])
    mlp_out = _mlp_apply(h, layer["mlp"], cfg)
    if cfg.use_post_norms:
        mlp_out = rms_norm(mlp_out, norms["post_mlp_norm"])
    return x + mlp_out, new_kv


def _slice_layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _slice_layer(v, i) for k, v in tree.items()}
    return tree[i]


def _embed(params, tokens, cfg):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        # A fill on the device, not a host tensor copied over: the copy
        # would make the host wait for the device at every step.
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def _logits(params, x, cfg):
    x = rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    if cfg.final_softcap is not None:
        logits = softcap(logits.to(torch.float32), cfg.final_softcap)
    return logits


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *, mode: str = "train"):
    """Full-sequence forward: (B, S) token ids -> (B, S, Vp) logits.

    With ``mode="prefill"`` it returns ``(logits, cache)`` as well, the
    cache ``{"kv": (k, v)}`` holding every layer's post-RoPE K/V stacked to
    ``(L, B, S, Hkv, hd)`` in the compute dtype (the reference's
    ``transformer.py:420-422``). The reference's aux losses are MoE-only and
    not returned.
    """
    x = _embed(params, tokens, cfg)
    b, seq = x.shape[:2]
    positions = torch.arange(seq, device=x.device)
    inv_freq = rope_frequencies(cfg.head_dim, cfg.rope_theta, device=x.device)
    prefill = mode == "prefill"
    if prefill:
        shape = (cfg.num_layers, b, seq, cfg.num_kv_heads, cfg.head_dim)
        ks = torch.empty(shape, dtype=x.dtype, device=x.device)
        vs = torch.empty(shape, dtype=x.dtype, device=x.device)
    for i, window in enumerate(window_flags(cfg)):
        x, (k, v) = decoder_layer(x, _slice_layer(params["layers"], i), cfg,
                                  window=window, positions=positions, inv_freq=inv_freq)
        if prefill:
            ks[i], vs[i] = k, v
    logits = _logits(params, x, cfg)
    if prefill:
        return logits, {"kv": (ks, vs)}
    return logits


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=torch.bfloat16,
               device="cuda") -> dict:
    """Empty dense decode cache ``{"kv": (k, v)}``, each (L, B, max_len, Hkv, hd)."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"kv": (torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))}


def decode_layers(params: dict, token: torch.Tensor, pos, cfg: ModelConfig,
                  layer_kv) -> torch.Tensor:
    """One token (B, 1) through every layer at position ``pos``.

    ``pos`` is an int, or a (B,) tensor of per-row positions (slots of a
    batched decode, each at its own position). ``layer_kv(i)`` gives layer
    i's cache view (``layers.DenseKV`` or the paged view of
    ``serving.kvcache``): the fresh K/V are written through it before the
    layer attends over what it returns. Returns the (B, 1, Vp) logits.
    """
    x = _embed(params, token, cfg)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        positions = pos[:, None]
    else:
        positions = pos + torch.arange(1, device=x.device)
    inv_freq = rope_frequencies(cfg.head_dim, cfg.rope_theta, device=x.device)
    for i, window in enumerate(window_flags(cfg)):
        x, _ = decoder_layer(x, _slice_layer(params["layers"], i), cfg,
                             window=window, positions=positions, inv_freq=inv_freq,
                             kv_cache=layer_kv(i), cache_index=pos)
    return _logits(params, x, cfg)


def decode_step(params: dict, token: torch.Tensor, cache: dict, pos, cfg: ModelConfig, *,
                ring_cache: bool = False):
    """One decode step against a dense cache. Returns ((B, 1, Vp) logits, cache).

    ``cache`` is :func:`init_cache`'s; the token's K/V are written into it
    in place at ``pos`` (an int, or (B,) per-row positions), so the returned
    cache is the one given. The reference's ring cache is for uniform
    sliding-window archs, which no ported config is: ``ring_cache=True``
    raises.
    """
    if ring_cache:
        if cfg.attention_pattern != "swa":
            raise ValueError("ring_cache requires a uniform sliding-window arch")
        raise NotImplementedError("the ring cache is not ported yet")
    ck, cv = cache["kv"]
    logits = decode_layers(params, token, pos, cfg, lambda i: DenseKV(ck[i], cv[i]))
    return logits, cache
