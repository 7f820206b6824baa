"""Decoder LM assembly, dense and MoE (counterpart of ``repro/models/transformer.py``).

Parameters keep the reference's stacked ``(num_layers, ...)`` layout under
the same path names (``layers/attn/wq``, ``layers/mlp/wi``,
``layers/moe/router``, ``layers/norms/attn_norm``, ...). ``forward`` runs
the train-mode (and prefill) pass as a Python loop over the stacked layers,
in place of the reference's ``lax.scan``; ``decode_step`` runs one token
through the same loop against a KV cache, written in place, or against the
reference's ring cache. The reference's activation checkpointing changes no
numbers and is not ported: the full-width models the card trains fit it
without.
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
from repro_torch.models.moe import moe_block

NO_WINDOW = 2**30


def _dense_init(gen: torch.Generator, shape, device, dtype, scale: float = 0.02):
    return (scale * torch.randn(shape, generator=gen, device=device, dtype=torch.float32)).to(dtype)


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda", dtype=torch.float32) -> dict:
    """Dense or MoE parameters from a seeded ``torch.Generator`` on ``device``.

    Same shapes, paths and init law (N(0, 0.02) matrices, unit norm gains)
    as the reference; the random draws differ, so parity tests carry the
    reference's own parameters over with ``repro_torch.interop``. An MoE
    layer has the ``moe`` group (router (L, D, E), experts wi/wg
    (L, E, D, F) and wo (L, E, F, D)) in place of ``mlp``.
    """
    if cfg.arch_type not in ("dense", "moe"):
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
    }
    if cfg.arch_type == "moe":
        E = cfg.num_experts
        layers["moe"] = {"router": init((L, D, E)), "wi": init((L, E, D, F)),
                         "wg": init((L, E, D, F)), "wo": init((L, E, F, D))}
    else:
        layers["mlp"] = {"wi": init((L, D, F)), "wo": init((L, F, D))}
        if cfg.mlp_act in ("swiglu", "geglu"):
            layers["mlp"]["wg"] = init((L, D, F))
    layers["norms"] = {"attn_norm": ones((L, D)), "mlp_norm": ones((L, D))}
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
                  kv_cache=None, cache_index=None, kv_len=None, ring: bool = False,
                  group_rows: bool = False):
    """One decoder layer: pre-norm attention, then the MLP or the MoE block
    (optional post norms).

    Returns ``(x, new_kv, aux)``: ``new_kv`` is the post-RoPE K/V without a
    cache (what prefill keeps), the attended cache with one (see
    ``layers.attention_block``); ``aux`` is the MoE layer's fp32
    ``(load_balance, z_loss)`` and None for an MLP layer (the reference's
    zeros). ``ring`` attends over a ring cache: no causal or window mask,
    only ``kv_len``. ``group_rows`` routes each row of the batch alone
    (``moe.moe_block``).
    """
    norms = layer["norms"]
    h = rms_norm(x, norms["attn_norm"])
    attn_out, new_kv = attention_block(
        h, layer["attn"], num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, positions=positions, inv_freq=inv_freq,
        window=None if ring else window, causal=not ring, attn_softcap=cfg.attn_softcap,
        kv_cache=kv_cache, cache_index=cache_index, kv_len=kv_len,
    )
    if cfg.use_post_norms:
        attn_out = rms_norm(attn_out, norms["post_attn_norm"])
    x = x + attn_out
    h = rms_norm(x, norms["mlp_norm"])
    if "moe" in layer:
        out = moe_block(h, layer["moe"], top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                        router_style=cfg.router_style, group_rows=group_rows)
        return x + out.y, new_kv, torch.stack([out.load_balance_loss, out.router_z_loss])
    mlp_out = _mlp_apply(h, layer["mlp"], cfg)
    if cfg.use_post_norms:
        mlp_out = rms_norm(mlp_out, norms["post_mlp_norm"])
    return x + mlp_out, new_kv, None


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


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *, mode: str = "train",
            return_aux: bool = False):
    """Full-sequence forward: (B, S) token ids -> (B, S, Vp) logits.

    With ``mode="prefill"`` it returns ``(logits, cache)`` as well, the
    cache ``{"kv": (k, v)}`` holding every layer's post-RoPE K/V stacked to
    ``(L, B, S, Hkv, hd)`` in the compute dtype (the reference's
    ``transformer.py:420-422``). The reference always returns its aux
    losses, ``(logits, aux[, cache])``; here ``return_aux=True`` gives
    exactly that, ``aux`` being ``{"load_balance", "z_loss"}``, each summed
    over the layers (fp32 zeros for a dense model), and the default leaves
    them out: ``logits`` or ``(logits, cache)``.
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
    aux = torch.zeros(2, dtype=torch.float32, device=x.device)
    for i, window in enumerate(window_flags(cfg)):
        x, (k, v), layer_aux = decoder_layer(x, _slice_layer(params["layers"], i), cfg,
                                             window=window, positions=positions,
                                             inv_freq=inv_freq)
        if layer_aux is not None:
            aux = aux + layer_aux
        if prefill:
            ks[i], vs[i] = k, v
    out = [_logits(params, x, cfg)]
    if return_aux:
        out.append({"load_balance": aux[0], "z_loss": aux[1]})
    if prefill:
        out.append({"kv": (ks, vs)})
    return out[0] if len(out) == 1 else tuple(out)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=torch.bfloat16,
               device="cuda") -> dict:
    """Empty dense decode cache ``{"kv": (k, v)}``, each (L, B, max_len, Hkv, hd)."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"kv": (torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))}


def decode_layers(params: dict, token: torch.Tensor, pos, cfg: ModelConfig, layer_kv, *,
                  cache_index=None, kv_len=None, ring: bool = False,
                  group_rows: bool = False) -> torch.Tensor:
    """One token (B, 1) through every layer at position ``pos``.

    ``pos`` is an int, or a (B,) tensor of per-row positions (slots of a
    batched decode, each at its own position). ``layer_kv(i)`` gives layer
    i's cache view (``layers.DenseKV`` or the paged view of
    ``serving.kvcache``): the fresh K/V are written through it at
    ``cache_index`` (``pos`` unless given) before the layer attends over
    what it returns, keys at and past ``kv_len`` (``cache_index + 1`` unless
    given) masked. ``ring`` drops the causal and window masks (the ring
    cache); ``group_rows`` routes each row's token alone through the MoE
    layers. Returns the (B, 1, Vp) logits.
    """
    x = _embed(params, token, cfg)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        positions = pos[:, None]
    else:
        positions = pos + torch.arange(1, device=x.device)
    if cache_index is None:
        cache_index = pos
    inv_freq = rope_frequencies(cfg.head_dim, cfg.rope_theta, device=x.device)
    for i, window in enumerate(window_flags(cfg)):
        x, _, _ = decoder_layer(x, _slice_layer(params["layers"], i), cfg,
                                window=window, positions=positions, inv_freq=inv_freq,
                                kv_cache=layer_kv(i), cache_index=cache_index, kv_len=kv_len,
                                ring=ring, group_rows=group_rows)
    return _logits(params, x, cfg)


def decode_step(params: dict, token: torch.Tensor, cache: dict, pos, cfg: ModelConfig, *,
                ring_cache: bool = False):
    """One decode step against a dense cache. Returns ((B, 1, Vp) logits, cache).

    ``cache`` is :func:`init_cache`'s; the token's K/V are written into it
    in place at ``pos`` (an int, or (B,) per-row positions), so the returned
    cache is the one given. MoE layers route the batch as one group, as the
    reference's decode does.

    ``ring_cache=True`` (uniform sliding-window archs only), as the
    reference: the buffer holds ``T`` = ``cache["kv"][0].shape[2]`` slots
    (the window), the token is written at ``pos % T``, and attention runs
    over the ``min(pos + 1, T)`` slots filled so far with no causal or
    window mask: RoPE was applied at absolute positions before caching, so
    eviction alone keeps the window.
    """
    ck, cv = cache["kv"]
    cache_index = kv_len = None
    if ring_cache:
        if cfg.attention_pattern != "swa":
            raise ValueError("ring_cache requires a uniform sliding-window arch")
        cache_len = ck.shape[2]
        cache_index = pos % cache_len
        kv_len = (torch.clamp(pos + 1, max=cache_len) if isinstance(pos, torch.Tensor)
                  else min(pos + 1, cache_len))
    logits = decode_layers(params, token, pos, cfg, lambda i: DenseKV(ck[i], cv[i]),
                           cache_index=cache_index, kv_len=kv_len, ring=ring_cache)
    return logits, cache
