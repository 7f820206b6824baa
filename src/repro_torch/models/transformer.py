"""Decoder LM assembly, dense subset (counterpart of ``repro/models/transformer.py``).

Parameters keep the reference's stacked ``(num_layers, ...)`` layout under
the same path names (``layers/attn/wq``, ``layers/mlp/wi``,
``layers/norms/attn_norm``, ...). ``forward`` runs the train-mode pass as a
Python loop over the stacked layers, in place of the reference's
``lax.scan``. The reference's activation checkpointing changes no numbers
and is not ported: the full-width model fits the card without it.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
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


def decoder_layer(x, layer: dict, cfg: ModelConfig, *, window: int, positions, inv_freq):
    """One dense decoder layer (pre-norm attention + MLP, optional post norms)."""
    norms = layer["norms"]
    h = rms_norm(x, norms["attn_norm"])
    attn_out = attention_block(
        h, layer["attn"], num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, positions=positions, inv_freq=inv_freq,
        window=window, attn_softcap=cfg.attn_softcap,
    )
    if cfg.use_post_norms:
        attn_out = rms_norm(attn_out, norms["post_attn_norm"])
    x = x + attn_out
    h = rms_norm(x, norms["mlp_norm"])
    mlp_out = _mlp_apply(h, layer["mlp"], cfg)
    if cfg.use_post_norms:
        mlp_out = rms_norm(mlp_out, norms["post_mlp_norm"])
    return x + mlp_out


def _slice_layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _slice_layer(v, i) for k, v in tree.items()}
    return tree[i]


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Train-mode full-sequence forward: (B, S) token ids -> (B, S, Vp) logits."""
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    positions = torch.arange(x.shape[1], device=x.device)
    inv_freq = rope_frequencies(cfg.head_dim, cfg.rope_theta, device=x.device)
    for i, window in enumerate(window_flags(cfg)):
        x = decoder_layer(x, _slice_layer(params["layers"], i), cfg,
                          window=window, positions=positions, inv_freq=inv_freq)
    x = rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    if cfg.final_softcap is not None:
        logits = softcap(logits.to(torch.float32), cfg.final_softcap)
    return logits
