"""Decoder LM assembly: dense, MoE, SSM, hybrid, VLM and audio layer stacks
(counterpart of ``repro/models/transformer.py``).

Parameters keep the reference's stacked ``(num_layers, ...)`` layout under
the same path names (``layers/attn/wq``, ``layers/mlp/wi``,
``layers/moe/router``, ``layers/ssm/wx``, ``layers/hybrid/attn_scale``,
``layers/cross/wq``, ``layers/norms/attn_norm``, ``encoder/...``). ``forward``
runs the train-mode (and prefill) pass as a Python loop over the stacked
layers, in place of the reference's ``lax.scan``; ``decode_step`` runs one
token through the same loop against a cache: the KV buffers written in
place (or the reference's ring cache), the SSM state replaced by the new
state tensors. The reference's activation checkpointing changes no numbers
and is not ported yet: the full-width dense and MoE models the card trains
fit without it, and ``mamba2-1.3b`` trains there at a cut depth.

With a tensor-parallel ``ctx`` (``sharding.specs.ShardCtx``; dense and MoE
models) each rank holds its ``param_specs`` shards and ``forward`` computes
with them, as the reference's model under GSPMD: the embedding
vocab-parallel, Q/K/V and the MLP's wi/wg column-parallel (the rank's
heads and d_ff columns), both ``wo`` row-parallel, the experts' ``d_ff``
split as the reference's ``shard_map`` splits it (``models/moe.py``), the
logits column-parallel over the vocab. Between layers the residual is
sequence-sharded over the model axis where the reference's ``_seq_shard``
shards it (``ctx.seq_shard``), so the norms run on the rank's sequence
shard; ``distributed/tensor_parallel.py`` holds the collectives.

Layers by ``arch_type``: dense and vlm (attention + MLP), moe (attention +
MoE block), ssm (Mamba2 only), hybrid (hymba: attention and SSM on one
normed input, ``0.5 * (attn * attn_scale + ssm * ssm_scale)``, then the
MLP), audio (whisper's decoder: self-attention without RoPE, then
cross-attention to the encoder's output, then the MLP; sinusoidal
positions). A VLM prepends its ``extra_embeds`` to the token embeddings.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    DenseKV,
    attention_block,
    geglu,
    rms_norm,
    rope_frequencies,
    sinusoidal_at,
    sinusoidal_positions,
    softcap,
    swiglu,
)
from repro_torch.models.moe import moe_block

NO_WINDOW = 2**30
ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def _dense_init(gen: torch.Generator, shape, device, dtype, scale: float = 0.02):
    return (scale * torch.randn(shape, generator=gen, device=device, dtype=torch.float32)).to(dtype)


def ssm_dims(cfg: ModelConfig) -> ssm_lib.SSMDims:
    return ssm_lib.make_dims(cfg.d_model, cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                             expand=cfg.ssm_expand)


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda", dtype=torch.float32) -> dict:
    """Parameters of any ported arch from a seeded ``torch.Generator`` on ``device``.

    Same shapes, paths and init law (N(0, 0.02) matrices, unit norm gains,
    the SSM's own constants) as the reference; the random draws differ, so
    parity tests carry the reference's own parameters over with
    ``repro_torch.interop``. An MoE layer has the ``moe`` group (router
    (L, D, E), experts wi/wg (L, E, D, F) and wo (L, E, F, D)) in place of
    ``mlp``; an SSM layer the ``ssm`` group (``ssm.init_ssm_params``,
    stacked) and ``norms/ssm_norm``; hymba both attention and SSM and the
    ``hybrid`` scales; whisper the ``encoder`` subtree, ``layers/cross`` and
    ``norms/cross_norm``.
    """
    arch = cfg.arch_type
    if arch not in ARCH_TYPES:
        raise NotImplementedError(f"arch_type {arch!r} is not ported")
    gen = torch.Generator(device=device).manual_seed(seed)
    L, D, F = cfg.num_layers, cfg.d_model, cfg.d_ff
    Vp = cfg.padded_vocab
    init = lambda shape: _dense_init(gen, shape, device, dtype)
    ones = lambda shape: torch.ones(shape, device=device, dtype=dtype)
    layers: dict = {"norms": {}}
    norms = layers["norms"]
    if arch in ("dense", "moe", "vlm", "audio", "hybrid"):
        layers["attn"] = {"wq": init((L, D, cfg.q_dim)), "wk": init((L, D, cfg.kv_dim)),
                          "wv": init((L, D, cfg.kv_dim)), "wo": init((L, cfg.q_dim, D))}
        norms["attn_norm"] = ones((L, D))
        if cfg.use_post_norms:
            norms["post_attn_norm"] = ones((L, D))
    if arch in ("dense", "vlm", "audio", "hybrid"):
        layers["mlp"] = {"wi": init((L, D, F)), "wo": init((L, F, D))}
        if cfg.mlp_act in ("swiglu", "geglu"):
            layers["mlp"]["wg"] = init((L, D, F))
        norms["mlp_norm"] = ones((L, D))
        if cfg.use_post_norms:
            norms["post_mlp_norm"] = ones((L, D))
    if arch == "moe":
        E = cfg.num_experts
        layers["moe"] = {"router": init((L, D, E)), "wi": init((L, E, D, F)),
                         "wg": init((L, E, D, F)), "wo": init((L, E, F, D))}
        norms["mlp_norm"] = ones((L, D))
    if arch in ("ssm", "hybrid"):
        layers["ssm"] = ssm_lib.init_ssm_params(gen, ssm_dims(cfg), lead=(L,), device=device,
                                                dtype=dtype)
        norms["ssm_norm"] = ones((L, D))
    if arch == "hybrid":
        layers["hybrid"] = {"attn_scale": ones((L, D)), "ssm_scale": ones((L, D))}
    params = {"embed": init((Vp, D)), "layers": layers, "final_norm": ones((D,))}
    if not cfg.tie_embeddings:
        params["lm_head"] = init((D, Vp))
    if arch == "audio":
        from repro_torch.models.encdec import init_encoder_params

        params["encoder"] = init_encoder_params(gen, cfg, device=device, dtype=dtype)
        layers["cross"] = {"wq": init((L, D, cfg.q_dim)), "wk": init((L, D, cfg.kv_dim)),
                           "wv": init((L, D, cfg.kv_dim)), "wo": init((L, cfg.q_dim, D))}
        norms["cross_norm"] = ones((L, D))
    return params


def window_flags(cfg: ModelConfig) -> list[int]:
    """Per-layer attention window (NO_WINDOW = global)."""
    L = cfg.num_layers
    if cfg.attention_pattern == "swa":
        return [cfg.window_size] * L
    if cfg.attention_pattern == "alternating":
        return [cfg.window_size if i % 2 == 0 else NO_WINDOW for i in range(L)]
    return [NO_WINDOW] * L


def _inv_freq(cfg: ModelConfig, device):
    """RoPE frequencies, or None: whisper's positions are sinusoidal and
    mamba2 has no attention."""
    if cfg.arch_type == "audio" or not cfg.num_heads:
        return None
    return rope_frequencies(cfg.head_dim, cfg.rope_theta, device=device)


def _mlp_apply(x, mlp, cfg):
    if cfg.mlp_act == "swiglu":
        return swiglu(x, mlp["wi"], mlp["wg"], mlp["wo"])
    if cfg.mlp_act == "geglu":
        return geglu(x, mlp["wi"], mlp["wg"], mlp["wo"])
    return torch.nn.functional.gelu(x @ mlp["wi"], approximate="tanh") @ mlp["wo"]


def _ssm_apply(h, layer, cfg, mode, ssm_state):
    """The SSM branch in ``mode``: (out, new state or None)."""
    dims = ssm_dims(cfg)
    if mode == "decode":
        return ssm_lib.ssm_decode_step(h, ssm_state, layer["ssm"], dims)
    if mode == "prefill":
        return ssm_lib.ssm_forward(h, layer["ssm"], dims, return_state=True)
    return ssm_lib.ssm_forward(h, layer["ssm"], dims), None


def _tp():
    # Imported where the tensor-parallel path runs: the distributed package
    # imports the specs, which import this module.
    from repro_torch.distributed import tensor_parallel

    return tensor_parallel


def decoder_layer(x, layer: dict, cfg: ModelConfig, *, window: int, positions, inv_freq,
                  mode: str = "train", kv_cache=None, ssm_state=None, cache_index=None,
                  kv_len=None, ring: bool = False, group_rows: bool = False, cross_kv=None,
                  ctx=None):
    """One decoder layer: the mixer (attention, SSM, or both for hymba),
    whisper's cross-attention, then the MLP or the MoE block.

    ``mode``: 'train', 'prefill' (the SSM returns its state) or 'decode'
    (one token against ``kv_cache`` and ``ssm_state``). Returns ``(x,
    new_kv, new_ssm, aux)``: ``new_kv`` is the post-RoPE K/V without a cache
    (what prefill keeps), the attended cache with one (see
    ``layers.attention_block``), None without attention; ``new_ssm`` the
    SSM state after the layer (prefill and decode) or None; ``aux`` the MoE
    layer's fp32 ``(load_balance, z_loss)`` and None otherwise (the
    reference's zeros). ``ring`` attends over a ring cache: no causal or
    window mask, only ``kv_len``. ``group_rows`` routes each row of the
    batch alone (``moe.moe_block``). ``cross_kv``: the encoder's output for
    whisper's cross-attention. ``ctx``: the model's context; tensor-parallel
    (a dense or MoE layer in 'train' mode), ``x`` is the rank's sequence
    shard of the residual (or the whole of it, unsharded) and so is the
    output; the MoE block routes the gathered sequence and its partial
    output is reduced as the row-parallel ``wo``'s.
    """
    norms = layer["norms"]
    new_kv = new_ssm = None
    tp = ctx is not None and ctx.tensor_parallel
    # Into and out of a tensor-parallel branch: the sequence gather and the
    # reduce of the row-parallel partial sums; the identity on one device.
    enter = (lambda h: _tp().gather_seq(h, ctx)) if tp else (lambda h: h)
    leave = (lambda h: _tp().reduce_seq(h, ctx)) if tp else (lambda h: h)

    def attend(h):
        out, kv = attention_block(
            enter(h), layer["attn"], num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, positions=positions, inv_freq=inv_freq,
            window=None if ring else window, causal=not ring, attn_softcap=cfg.attn_softcap,
            kv_cache=kv_cache, cache_index=cache_index, kv_len=kv_len, ctx=ctx,
        )
        return leave(out), kv

    if "attn" in layer and "ssm" in layer:  # hymba: both branches on one normed input
        h = rms_norm(x, norms["attn_norm"])
        attn_out, new_kv = attend(h)
        ssm_out, new_ssm = _ssm_apply(h, layer, cfg, mode, ssm_state)
        scales = layer["hybrid"]
        x = x + 0.5 * (attn_out * scales["attn_scale"] + ssm_out * scales["ssm_scale"])
    elif "attn" in layer:
        attn_out, new_kv = attend(rms_norm(x, norms["attn_norm"]))
        if cfg.use_post_norms:
            attn_out = rms_norm(attn_out, norms["post_attn_norm"])
        x = x + attn_out
    else:  # pure SSM (mamba2)
        ssm_out, new_ssm = _ssm_apply(rms_norm(x, norms["ssm_norm"]), layer, cfg, mode,
                                      ssm_state)
        x = x + ssm_out

    if cross_kv is not None:
        cross_out, _ = attention_block(
            rms_norm(x, norms["cross_norm"]), layer["cross"], num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, positions=positions,
            inv_freq=None, attn_softcap=cfg.attn_softcap, cross_kv=cross_kv, ctx=ctx)
        x = x + cross_out

    aux = None
    if "moe" in layer:
        out = moe_block(enter(rms_norm(x, norms["mlp_norm"])), layer["moe"], top_k=cfg.top_k,
                        capacity_factor=cfg.capacity_factor, router_style=cfg.router_style,
                        group_rows=group_rows, ctx=ctx)
        x = x + leave(out.y)
        aux = torch.stack([out.load_balance_loss, out.router_z_loss])
    elif "mlp" in layer:
        mlp_out = leave(_mlp_apply(enter(rms_norm(x, norms["mlp_norm"])), layer["mlp"], cfg))
        if cfg.use_post_norms:
            mlp_out = rms_norm(mlp_out, norms["post_mlp_norm"])
        x = x + mlp_out
    return x, new_kv, new_ssm, aux


def _slice_layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _slice_layer(v, i) for k, v in tree.items()}
    return tree[i]


def _embed(params, tokens, cfg, ctx=None):
    if ctx is not None and ctx.tensor_parallel:
        x = _tp().embed_lookup(params["embed"], tokens, ctx)
    else:
        x = params["embed"][tokens]
    if cfg.embed_scale:
        # A fill on the device, not a host tensor copied over: the copy
        # would make the host wait for the device at every step.
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def _logits(params, x, cfg, ctx=None):
    """The final norm and the head; tensor-parallel, the norm runs on the
    rank's sequence shard and the logits are the rank's vocab columns."""
    x = rms_norm(x, params["final_norm"])
    if ctx is not None and ctx.tensor_parallel:
        x = _tp().gather_seq(x, ctx)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    if cfg.final_softcap is not None:
        logits = softcap(logits.to(torch.float32), cfg.final_softcap)
    return logits


def _stack_states(states: list) -> dict:
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *, mode: str = "train",
            return_aux: bool = False, extra_embeds: Optional[torch.Tensor] = None,
            encoder_frames: Optional[torch.Tensor] = None, ctx=None):
    """Full-sequence forward: (B, S) token ids -> (B, S', Vp) logits.

    ``extra_embeds`` (B, V, D): a VLM's patch embeddings, prepended to the
    text (S' = V + S; the positions cover them). ``encoder_frames``
    (B, S_enc, D): whisper's frame embeddings, which the encoder turns into
    the cross-attention's K/V source (required for the audio arch).

    With ``mode="prefill"`` it returns ``(logits, cache)`` as well: ``"kv"``
    holds every attention layer's post-RoPE K/V stacked to
    ``(L, B, S', Hkv, hd)`` in the compute dtype (absent for mamba2), and
    ``"ssm"`` every SSM layer's state stacked over the layers (``h`` fp32,
    the conv windows in the compute dtype), the reference's
    ``transformer.py:420-422``. The reference always returns its aux
    losses, ``(logits, aux[, cache])``; here ``return_aux=True`` gives
    exactly that, ``aux`` being ``{"load_balance", "z_loss"}``, each summed
    over the layers (fp32 zeros but for MoE), and the default leaves them
    out: ``logits`` or ``(logits, cache)``.

    ``ctx`` (``sharding.specs.ShardCtx``): the heads' layouts on one device;
    tensor-parallel (dense or MoE, 'train' mode), ``params`` are the rank's
    shards, ``tokens`` the rows of its data coordinate, and the logits the
    rank's (B, S, Vp/m) vocab columns.
    """
    tp = ctx is not None and ctx.tensor_parallel
    if tp:
        from repro_torch.sharding.specs import TP_ARCHS, sequence_sharded

        if cfg.arch_type not in TP_ARCHS or mode != "train":
            raise NotImplementedError(f"the tensor-parallel forward runs {' and '.join(TP_ARCHS)} "
                                      f"models in 'train' mode, not {cfg.arch_type} in {mode!r}")
        if ctx.seq_shard != sequence_sharded(tokens.shape[1], ctx.size):
            raise ValueError(f"the context's seq_shard={ctx.seq_shard} was made for another "
                             f"sequence length than {tokens.shape[1]}")
    x = _embed(params, tokens, cfg, ctx)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    # The whole sequence: a tensor-parallel rank's residual holds its shard.
    b, seq = x.shape[0], tokens.shape[1] + (0 if extra_embeds is None else extra_embeds.shape[1])
    positions = torch.arange(seq, device=x.device)
    inv_freq = _inv_freq(cfg, x.device)
    cross_kv = None
    if cfg.arch_type == "audio":
        from repro_torch.models.encdec import encode

        if encoder_frames is None:
            raise ValueError("audio arch requires encoder_frames")
        cross_kv = encode(params["encoder"], encoder_frames, cfg)
        x = x + sinusoidal_positions(seq, cfg.d_model, device=x.device).to(x.dtype)[None]
    prefill = mode == "prefill"
    has_kv = "attn" in params["layers"]
    if prefill and has_kv:
        shape = (cfg.num_layers, b, seq, cfg.num_kv_heads, cfg.head_dim)
        ks = torch.empty(shape, dtype=x.dtype, device=x.device)
        vs = torch.empty(shape, dtype=x.dtype, device=x.device)
    states = []
    aux = torch.zeros(2, dtype=torch.float32, device=x.device)
    for i, window in enumerate(window_flags(cfg)):
        layer = _slice_layer(params["layers"], i)
        x, kv, new_ssm, layer_aux = decoder_layer(
            x, layer, cfg, window=window, positions=positions, inv_freq=inv_freq,
            mode="prefill" if prefill else "train",
            cross_kv=cross_kv if "cross" in layer else None, ctx=ctx)
        if layer_aux is not None:
            aux = aux + layer_aux
        if prefill:
            if has_kv:
                ks[i], vs[i] = kv
            if new_ssm is not None:
                states.append(new_ssm)
    out = [_logits(params, x, cfg, ctx)]
    if return_aux:
        out.append({"load_balance": aux[0], "z_loss": aux[1]})
    if prefill:
        cache = {"kv": (ks, vs)} if has_kv else {}
        if states:
            cache["ssm"] = _stack_states(states)
        out.append(cache)
    return out[0] if len(out) == 1 else tuple(out)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=torch.bfloat16,
               device="cuda") -> dict:
    """Empty decode cache: ``"kv"`` (k, v), each (L, B, max_len, Hkv, hd) in
    ``dtype``, for every arch with attention; ``"ssm"`` for mamba2 and hymba:
    ``h`` (L, B, H, P, N) fp32 and the conv windows (L, B, K-1, C) in
    ``dtype``."""
    cache: dict = {}
    L = cfg.num_layers
    if cfg.num_heads and cfg.arch_type != "ssm":
        shape = (L, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        cache["kv"] = (torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))
    if cfg.arch_type in ("ssm", "hybrid"):
        state = ssm_lib.init_decode_state(batch * L, ssm_dims(cfg), dtype=dtype, device=device)
        cache["ssm"] = {k: v.reshape(L, batch, *v.shape[1:]) for k, v in state.items()}
    return cache


def decode_layers(params: dict, token: torch.Tensor, pos, cfg: ModelConfig, layer_kv, *,
                  cache_index=None, kv_len=None, ring: bool = False,
                  group_rows: bool = False, ssm_cache: Optional[dict] = None,
                  encoder_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token (B, 1) through every layer at position ``pos``.

    ``pos`` is an int, or a (B,) tensor of per-row positions (slots of a
    batched decode, each at its own position). ``layer_kv(i)`` gives layer
    i's cache view (``layers.DenseKV`` or the paged view of
    ``serving.kvcache``): the fresh K/V are written through it at
    ``cache_index`` (``pos`` unless given) before the layer attends over
    what it returns, keys at and past ``kv_len`` (``cache_index + 1`` unless
    given) masked. ``ring`` drops the causal and window masks (the ring
    cache); ``group_rows`` routes each row's token alone through the MoE
    layers. ``ssm_cache``: the SSM state stacked over the layers
    (``init_cache``'s ``"ssm"``), whose tensors are replaced by the state
    after the step. ``encoder_out``: whisper's encoder output, for the
    cross-attention (required when the layers have it); whisper's position
    embedding is row ``pos`` of the sinusoidal table. Returns the (B, 1, Vp)
    logits.
    """
    x = _embed(params, token, cfg)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        positions = pos[:, None]
    else:
        positions = pos + torch.arange(1, device=x.device)
    if cache_index is None:
        cache_index = pos
    if cfg.arch_type == "audio":
        x = x + sinusoidal_at(positions, cfg.d_model).to(x.dtype)
        if encoder_out is None:
            raise ValueError("audio arch decodes against encoder_out")
    inv_freq = _inv_freq(cfg, x.device)
    states = []
    for i, window in enumerate(window_flags(cfg)):
        layer = _slice_layer(params["layers"], i)
        x, _, new_ssm, _ = decoder_layer(
            x, layer, cfg, window=window, positions=positions, inv_freq=inv_freq,
            mode="decode", kv_cache=layer_kv(i) if "attn" in layer else None,
            ssm_state=_slice_layer(ssm_cache, i) if "ssm" in layer else None,
            cache_index=cache_index, kv_len=kv_len, ring=ring, group_rows=group_rows,
            cross_kv=encoder_out if "cross" in layer else None)
        if new_ssm is not None:
            states.append(new_ssm)
    if states:
        ssm_cache.update(_stack_states(states))
    return _logits(params, x, cfg)


def decode_step(params: dict, token: torch.Tensor, cache: dict, pos, cfg: ModelConfig, *,
                ring_cache: bool = False, encoder_out: Optional[torch.Tensor] = None):
    """One decode step against a dense cache. Returns ((B, 1, Vp) logits, cache).

    ``cache`` is :func:`init_cache`'s (or ``serving.cache_from_prefill``'s);
    the token's K/V are written into it in place at ``pos`` (an int, or
    (B,) per-row positions) and its SSM state replaced by the state after
    the step, so the returned cache is the one given. MoE layers route the
    batch as one group, as the reference's decode does. ``encoder_out``:
    whisper's encoder output (``encdec.encode``).

    ``ring_cache=True`` (uniform sliding-window archs only: mixtral, hymba),
    as the reference: the buffer holds ``T`` = ``cache["kv"][0].shape[2]``
    slots (the window), the token is written at ``pos % T``, and attention
    runs over the ``min(pos + 1, T)`` slots filled so far with no causal or
    window mask: RoPE was applied at absolute positions before caching, so
    eviction alone keeps the window.
    """
    kv = cache.get("kv")
    cache_index = kv_len = None
    if ring_cache:
        if cfg.attention_pattern != "swa":
            raise ValueError("ring_cache requires a uniform sliding-window arch")
        cache_len = kv[0].shape[2]
        cache_index = pos % cache_len
        kv_len = (torch.clamp(pos + 1, max=cache_len) if isinstance(pos, torch.Tensor)
                  else min(pos + 1, cache_len))
    layer_kv = (lambda i: DenseKV(kv[0][i], kv[1][i])) if kv is not None else None
    logits = decode_layers(params, token, pos, cfg, layer_kv, cache_index=cache_index,
                           kv_len=kv_len, ring=ring_cache, ssm_cache=cache.get("ssm"),
                           encoder_out=encoder_out)
    return logits, cache
