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
state tensors; tensor-parallel, against the rank's ``cache_specs`` shard of
the cache (``decode_layers``). In train mode each layer runs under activation
checkpointing, as the reference's ``jax.checkpoint`` of its scan body:
only the residual entering the layer is kept for the backward, and the
layer's forward runs again there (its collectives too, tensor-parallel).

With a tensor-parallel ``ctx`` (``sharding.specs.ShardCtx``; every arch)
each rank holds its ``param_specs`` shards and ``forward`` computes with
them, as the reference's model under GSPMD: the embedding vocab-parallel
(a VLM's vision rows put ahead of the text before the sum), Q/K/V (whisper's
cross-attention and encoder too) and the MLP's wi/wg column-parallel (the
rank's heads, or in the 'hd' layout its head_dim slice of every head, and
its d_ff columns), both ``wo`` row-parallel, the experts' ``d_ff`` split
as the reference's ``shard_map`` splits it (``models/moe.py``), the SSM's
``d_inner`` columns and heads split (``models/ssm.py``, ``out_proj``
row-parallel), the logits column-parallel over the vocab. What the model
axis does not divide (``sharding.specs.whole_sub_blocks``: Q or K/V heads
with no layout, ``d_ff``, an expert ``d_ff``, ``d_inner``, the padded
vocab) the rank holds whole, as the reference keeps it replicated, and
such a sub-block runs whole on every rank, on its rows' whole sequence:
the rank keeps its own sequence shard of the output
(``tensor_parallel.enter_whole`` / ``leave_whole``), so the sub-block
enters no reduce over the model axis and its gradients come out whole on
every rank; with the vocab whole the lookup, the logits and the cross
entropy are the plain ones. Between layers
the residual is sequence-sharded over the model axis where the reference's
``_seq_shard`` shards it (``ctx.seq_shard``), so the norms run on the
rank's sequence shard; ``distributed/tensor_parallel.py`` holds the
collectives. whisper's encoder follows its own length's rule
(``encdec.encode``) and its output is gathered whole once, as the K/V
source of every decoder layer's cross-attention. Training, prefill and
decode all run so; a prefill lays its cache out as the rank's
``sharding.specs.cache_specs`` shard (its heads, its head_dim slice of
every head, or its positions where the cache's sequence splits over
``model`` or the data axes), and a decode step attends against that shard
(``layers._cached_attention_tp``).

Layers by ``arch_type``: dense and vlm (attention + MLP), moe (attention +
MoE block), ssm (Mamba2 only), hybrid (hymba: attention and SSM on one
normed input, ``0.5 * (attn * attn_scale + ssm * ssm_scale)``, then the
MLP), audio (whisper's decoder: self-attention without RoPE, then
cross-attention to the encoder's output, then the MLP; sinusoidal
positions). A VLM prepends its ``extra_embeds`` to the token embeddings.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    FLASH_BLOCK_K,
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


def _ssm_apply(h, layer, cfg, mode, ssm_state, ctx=None):
    """The SSM branch in ``mode``: (out, new state or None); ``ctx`` as
    ``ssm.ssm_forward``'s and ``ssm.ssm_decode_step``'s."""
    dims = ssm_dims(cfg)
    if mode == "decode":
        return ssm_lib.ssm_decode_step(h, ssm_state, layer["ssm"], dims, ctx=ctx)
    if mode == "prefill":
        return ssm_lib.ssm_forward(h, layer["ssm"], dims, return_state=True, ctx=ctx)
    return ssm_lib.ssm_forward(h, layer["ssm"], dims, ctx=ctx), None


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
    (every mode), ``x`` is the rank's sequence shard of the residual (or
    the whole of it, unsharded, as a decode step's one position always
    is) and so is the output; ``kv_cache`` the rank's shard
    (``layers.attention_block``), ``ssm_state`` too; the cross-attention's
    Q comes from the gathered sequence and its K/V from the rank's heads of
    the whole encoder output; the MoE block routes the gathered sequence
    and its partial output is reduced as the row-parallel ``wo``'s, and so
    is the SSM's ``out_proj``. hymba's attention and SSM read one gathered
    input, and one reduce closes both: ``0.5 * (attn * attn_scale + ssm *
    ssm_scale)`` is linear in the two partial sums, so this is the
    reference's sum in another order, with half the reduce bytes. A
    sub-block the model axis leaves whole (``ctx.attn_whole``,
    ``mlp_whole``, ``experts_whole``, ``ssm_whole``) runs whole on every
    rank and keeps the rank's sequence shard of its output
    (``tensor_parallel.enter_whole`` / ``leave_whole``); hymba's two
    branches do so when both are whole, and a whole one beside a split one
    adds its output to the one reduce's partial sum on model index 0 alone
    (``ctx.whole_on_index0``). The
    self- and cross-attention scan K/V in blocks of ``ctx.flash_block_k``
    (``layers.attention``; 1024 without a context).
    """
    norms = layer["norms"]
    new_kv = new_ssm = None
    tp = ctx is not None and ctx.tensor_parallel
    block_k = FLASH_BLOCK_K if ctx is None else ctx.flash_block_k
    # What the model axis leaves whole (ShardCtx): such a sub-block runs
    # whole on every rank, on the one-device code where it has its own.
    attn_whole = tp and ctx.attn_whole
    ssm_whole = tp and ctx.ssm_whole

    def enter(h, whole: bool = False):
        """Into a tensor-parallel branch: the sequence gather (for a split
        one, its backward sums the partial cotangents; for a whole one, it
        takes the rank's slice of the whole cotangent); the identity on one
        device."""
        if not tp:
            return h
        return _tp().enter_whole(h, ctx) if whole else _tp().gather_seq(h, ctx)

    def leave(h, whole: bool = False):
        """Out of it: the reduce of a split branch's partial sums, or a whole
        branch's output cut to the rank's sequence shard."""
        if not tp:
            return h
        return _tp().leave_whole(h, ctx) if whole else _tp().reduce_seq(h, ctx)

    def attend(h):
        """The attention's output (the rank's partial sum, tensor-parallel,
        unless ``attn_whole``) on the entered input ``h``."""
        return attention_block(
            h, layer["attn"], num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, positions=positions, inv_freq=inv_freq,
            window=None if ring else window, causal=not ring, attn_softcap=cfg.attn_softcap,
            kv_cache=kv_cache, cache_index=cache_index, kv_len=kv_len, block_k=block_k,
            ctx=ctx,
        )

    if "attn" in layer and "ssm" in layer:  # hymba: both branches on one normed input
        both = attn_whole and ssm_whole
        h = enter(rms_norm(x, norms["attn_norm"]), both)
        attn_out, new_kv = attend(h)
        ssm_out, new_ssm = _ssm_apply(h, layer, cfg, mode, ssm_state,
                                      None if ssm_whole else ctx)
        if tp and not both and ctx.index:
            # A whole branch beside a split one enters the one reduce's
            # partial sum on model index 0 alone.
            if attn_whole:
                attn_out = torch.zeros_like(attn_out)
            if ssm_whole:
                ssm_out = torch.zeros_like(ssm_out)
        scales = layer["hybrid"]
        x = x + leave(0.5 * (attn_out * scales["attn_scale"] + ssm_out * scales["ssm_scale"]),
                      both)
    elif "attn" in layer:
        attn_out, new_kv = attend(enter(rms_norm(x, norms["attn_norm"]), attn_whole))
        attn_out = leave(attn_out, attn_whole)
        if cfg.use_post_norms:
            attn_out = rms_norm(attn_out, norms["post_attn_norm"])
        x = x + attn_out
    else:  # pure SSM (mamba2)
        ssm_out, new_ssm = _ssm_apply(enter(rms_norm(x, norms["ssm_norm"]), ssm_whole), layer,
                                      cfg, mode, ssm_state, None if ssm_whole else ctx)
        x = x + leave(ssm_out, ssm_whole)

    if cross_kv is not None:
        cross_out, _ = attention_block(
            enter(rms_norm(x, norms["cross_norm"]), attn_whole), layer["cross"],
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            positions=positions, inv_freq=None, attn_softcap=cfg.attn_softcap,
            cross_kv=cross_kv, block_k=block_k, ctx=ctx)
        x = x + leave(cross_out, attn_whole)

    aux = None
    if "moe" in layer:
        whole = tp and ctx.experts_whole
        out = moe_block(enter(rms_norm(x, norms["mlp_norm"]), whole), layer["moe"],
                        top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                        router_style=cfg.router_style, group_rows=group_rows,
                        ctx=None if whole else ctx)
        x = x + leave(out.y, whole)
        aux = torch.stack([out.load_balance_loss, out.router_z_loss])
    elif "mlp" in layer:
        whole = tp and ctx.mlp_whole
        mlp_out = leave(_mlp_apply(enter(rms_norm(x, norms["mlp_norm"]), whole), layer["mlp"],
                                   cfg), whole)
        if cfg.use_post_norms:
            mlp_out = rms_norm(mlp_out, norms["post_mlp_norm"])
        x = x + mlp_out
    return x, new_kv, new_ssm, aux


def _slice_layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _slice_layer(v, i) for k, v in tree.items()}
    return tree[i]


def _embed(params, tokens, cfg, ctx=None, prefix=None):
    """The token embeddings, with ``prefix`` (B, V, D), a VLM's vision
    embeddings, ahead of them; tensor-parallel, the rank's sequence shard
    of the whole ``V + S`` sequence (``tensor_parallel.embed_lookup``; with
    the vocab whole on every rank, the plain lookup's shard,
    ``tensor_parallel.leave_whole``)."""
    scale = cfg.d_model ** 0.5 if cfg.embed_scale else None
    tp = ctx is not None and ctx.tensor_parallel
    if tp and not ctx.vocab_whole:
        return _tp().embed_lookup(params["embed"], tokens, ctx, scale=scale, prefix=prefix)
    x = params["embed"][tokens]
    if scale is not None:
        # A fill on the device, not a host tensor copied over: the copy
        # would make the host wait for the device at every step.
        x = x * torch.full((), scale, dtype=x.dtype, device=x.device)
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    return _tp().leave_whole(x, ctx) if tp else x


def _logits(params, x, cfg, ctx=None):
    """The final norm and the head; tensor-parallel, the norm runs on the
    rank's sequence shard and the logits are the rank's vocab columns (all
    of them, the same on every rank, where the vocab is whole)."""
    x = rms_norm(x, params["final_norm"])
    if ctx is not None and ctx.tensor_parallel:
        x = (_tp().enter_whole if ctx.vocab_whole else _tp().gather_seq)(x, ctx)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    if cfg.final_softcap is not None:
        logits = logits.to(torch.float32)
        if torch.is_grad_enabled():
            logits = softcap(logits, cfg.final_softcap)
        else:  # in place, the same ops: a prefill's (B, S, Vp) logits are GBs
            logits = logits.div_(cfg.final_softcap).tanh_().mul_(cfg.final_softcap)
    return logits


def _stack_states(states: list) -> dict:
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


class _KeepInput(torch.autograd.Function):
    """Keeps a checkpointed layer's input for the backward through autograd,
    where saved-tensor hooks outside the checkpoint see it; its output is
    an empty tensor."""

    @staticmethod
    def forward(fctx, x):
        fctx.save_for_backward(x)
        return x.new_empty(0)

    @staticmethod
    def backward(fctx, grad):
        return None


def _checkpointed(body, x):
    """``body(x)`` under activation checkpointing: autograd keeps ``x`` (the
    residual entering a layer) and nothing the body saves; the backward's
    first read of one of those runs the whole body again on ``x`` and keeps
    what it saves, in the same order. So a tensor-parallel layer's
    recompute issues every forward collective of the layer once more, on
    every rank in the same order. This is ``torch.utils.checkpoint``'s
    non-reentrant scheme without its early stop; that function also imports
    ``torch._dynamo`` on its first call, seconds in every process (each rank
    of a mesh). No layer draws random numbers, so no RNG state is kept."""
    if not torch.is_grad_enabled():
        return body(x)
    keep = _KeepInput.apply(x) if x.requires_grad else x
    again: list = []

    def unpack(i: int):
        if not again:
            h = keep.grad_fn.saved_tensors[0] if keep.grad_fn is not None else keep
            # Detached: the recompute's own graph is dropped, and a saved-
            # tensor hook that held it would keep a cycle through autograd.
            with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                    lambda t: again.append(t.detach()), lambda _: None):
                body(h.detach().requires_grad_(h.requires_grad))
        return again[i]

    count = itertools.count()
    with torch.autograd.graph.saved_tensors_hooks(lambda _: next(count), unpack):
        return body(x)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *, mode: str = "train",
            return_aux: bool = False, extra_embeds: Optional[torch.Tensor] = None,
            encoder_frames: Optional[torch.Tensor] = None, ctx=None, remat: bool = True):
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

    ``ctx`` (``sharding.specs.ShardCtx``): the heads' layouts and the
    attention's KV block (``flash_block_k``) on one device; tensor-parallel
    (both modes), ``params`` are the rank's shards, ``tokens`` (and the
    extras) the rows of its data coordinate, and the logits the rank's
    (B, S', Vp/m) vocab columns; ``ctx.seq_shard`` was made for the
    residual's whole length S'. A context made for a decode layout
    (``cache_len``: ``sharding.specs.make_ctx(..., cache_len=)``, required
    for a tensor-parallel prefill, optional on one device) makes the
    prefill's cache that decode buffer: ``cache_len`` positions, the
    prompt's at their own (zeros past it), or on a ``ring_cache`` the last
    ``cache_len`` at ``p % cache_len``; tensor-parallel, each leaf is the
    rank's ``cache_specs`` shard (``_cache_kv``; the SSM state
    ``ssm.ssm_forward``'s), the prefill's forward the train mode's
    sequence-parallel one without checkpointing.

    ``remat`` (the reference's, on by default): in 'train' mode each
    decoder layer (its slice of the stacked parameters and
    ``decoder_layer``) runs under activation checkpointing, so the backward
    keeps one residual a layer, the rank's sequence shard when
    tensor-parallel, and recomputes the rest; the MoE aux losses leave the
    checkpoint as an output. The numbers are those of ``remat=False``,
    bitwise. whisper's encoder is not checkpointed, as the reference's is
    not; prefill never is.
    """
    tp = ctx is not None and ctx.tensor_parallel
    # The whole sequence: a tensor-parallel rank's residual holds its shard.
    seq = tokens.shape[1] + (0 if extra_embeds is None else extra_embeds.shape[1])
    prefill = mode == "prefill"
    if tp:
        from repro_torch.sharding.specs import sequence_sharded

        if ctx.seq_shard != sequence_sharded(seq, ctx.size):
            raise ValueError(f"the context's seq_shard={ctx.seq_shard} was made for another "
                             f"residual length than {seq}")
    if prefill and (tp or (ctx is not None and ctx.mesh_cache)):
        _check_decode_ctx(cfg, ctx, rows=tokens.shape[0])
    x = _embed(params, tokens, cfg, ctx, prefix=extra_embeds)
    b = x.shape[0]
    positions = torch.arange(seq, device=x.device)
    inv_freq = _inv_freq(cfg, x.device)
    cross_kv = None
    if cfg.arch_type == "audio":
        from repro_torch.models.encdec import encode

        if encoder_frames is None:
            raise ValueError("audio arch requires encoder_frames")
        cross_kv = encode(params["encoder"], encoder_frames, cfg, ctx)
        pos = sinusoidal_positions(seq, cfg.d_model, device=x.device).to(x.dtype)
        if tp and ctx.seq_shard:
            pos = pos.narrow(0, ctx.index * x.shape[1], x.shape[1])
        x = x + pos[None]
    has_kv = "attn" in params["layers"]
    laid_out = prefill and ctx is not None and ctx.cache_len is not None
    if prefill and has_kv:
        shape = (cfg.num_layers, b, seq, cfg.num_kv_heads, cfg.head_dim)
        if laid_out:
            shape = (cfg.num_layers, *_local_kv_shape(cfg, ctx, b))
        ks = torch.empty(shape, dtype=x.dtype, device=x.device)
        vs = torch.empty(shape, dtype=x.dtype, device=x.device)
    states = []
    aux = torch.zeros(2, dtype=torch.float32, device=x.device)

    def layer_at(h, i: int, window: int):
        layer = _slice_layer(params["layers"], i)
        return decoder_layer(h, layer, cfg, window=window, positions=positions,
                             inv_freq=inv_freq, mode="prefill" if prefill else "train",
                             cross_kv=cross_kv if "cross" in layer else None, ctx=ctx)

    for i, window in enumerate(window_flags(cfg)):
        if remat and mode == "train":
            x, kv, new_ssm, layer_aux = _checkpointed(
                functools.partial(layer_at, i=i, window=window), x)
        else:
            x, kv, new_ssm, layer_aux = layer_at(x, i, window)
        if layer_aux is not None:
            aux = aux + layer_aux
        if prefill:
            if has_kv:
                ks[i], vs[i] = _cache_kv(kv, cfg, ctx) if laid_out else kv
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


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The whole decode cache's leaf shapes (:func:`init_cache`'s tree):
    ``"kv"`` (k, v), each (L, B, max_len, Hkv, hd), for every arch with
    attention; ``"ssm"`` for mamba2 and hymba: ``h`` (L, B, H, P, N) and the
    conv windows (L, B, K-1, C)."""
    shapes: dict = {}
    L = cfg.num_layers
    if cfg.num_heads and cfg.arch_type != "ssm":
        kv = (L, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        shapes["kv"] = (kv, kv)
    if cfg.arch_type in ("ssm", "hybrid"):
        dims = ssm_dims(cfg)
        kk = dims.conv_kernel - 1
        shapes["ssm"] = {"h": (L, batch, dims.num_heads, dims.head_dim, dims.state_size),
                         "conv_x": (L, batch, kk, dims.d_inner),
                         "conv_b": (L, batch, kk, dims.state_size),
                         "conv_c": (L, batch, kk, dims.state_size)}
    return shapes


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=torch.bfloat16,
               device="cuda", ctx=None) -> dict:
    """Empty decode cache: ``"kv"`` (k, v), each (L, B, max_len, Hkv, hd) in
    ``dtype``, for every arch with attention; ``"ssm"`` for mamba2 and hymba:
    ``h`` (L, B, H, P, N) fp32 and the conv windows (L, B, K-1, C) in
    ``dtype`` (:func:`cache_shapes`).

    With a tensor-parallel ``ctx`` made for a decode layout
    (``sharding.specs.make_ctx(..., batch=, cache_len=)``; ``batch`` and
    ``max_len`` must be its), each leaf is the rank's
    ``sharding.specs.cache_specs`` shard, never the whole (the context's
    ``cache_shapes``); so on a mesh without a model split
    (``ctx.mesh_cache``)."""
    shapes = cache_shapes(cfg, batch, max_len)
    if ctx is not None and (ctx.tensor_parallel or ctx.mesh_cache):
        _check_decode_ctx(cfg, ctx)
        if (batch, max_len) != (ctx.cache_batch, ctx.cache_len):
            raise ValueError(f"the context's decode layout is {ctx.cache_batch} rows x "
                             f"{ctx.cache_len} positions, not {batch} x {max_len}")
        shapes = ctx.cache_shapes
    cache: dict = {}
    if "kv" in shapes:
        cache["kv"] = tuple(torch.zeros(shape, dtype=dtype, device=device)
                            for shape in shapes["kv"])
    if "ssm" in shapes:
        cache["ssm"] = {k: torch.zeros(shape, dtype=torch.float32 if k == "h" else dtype,
                                       device=device)
                        for k, shape in shapes["ssm"].items()}
    return cache


def _check_decode_ctx(cfg: ModelConfig, ctx, rows: Optional[int] = None) -> None:
    """A prefill or decode on a mesh needs a context made for a decode
    layout, and the rows its data coordinate holds (``rows``: the batch's)."""
    if ctx.cache_len is None:
        raise ValueError(f"{cfg.name}: a tensor-parallel prefill or decode needs a context "
                         "made for a decode layout (sharding.specs.make_ctx(..., batch=, "
                         "cache_len=))")
    if rows is not None:
        want = ctx.cache_shapes
        want = want["kv"][0][1] if "kv" in want else want["ssm"]["h"][1]
        if rows != want:
            raise ValueError(f"{cfg.name}: the rank's batch holds {rows} rows; its data "
                             f"coordinate's share of {ctx.cache_batch} is {want}")


def _local_kv_shape(cfg: ModelConfig, ctx, rows: int) -> tuple:
    """One layer's (rows, T, Hkv, hd) K (or V) cache shard of the rank."""
    if ctx.cache_shapes is None:
        return (rows, ctx.cache_len, cfg.num_kv_heads, cfg.head_dim)
    return ctx.cache_shapes["kv"][0][1:]


def _in_buffer(t: torch.Tensor, length: int, ring: bool) -> torch.Tensor:
    """(B, S, ...) prefill K or V at positions 0..S-1 -> the (B, length, ...)
    decode buffer holding them: position p at slot p (zeros past S), or on
    a ring slot ``p % length``, the last ``length`` positions kept."""
    seq = t.shape[1]
    if seq > length and not ring:
        raise ValueError(f"prefill of {seq} positions does not fit a cache of {length}")
    buf = t.new_zeros((t.shape[0], length, *t.shape[2:]))
    first = max(0, seq - length)
    slots = torch.arange(first, seq, device=t.device) % length
    buf[:, slots] = t[:, first:]
    return buf


def _cache_kv(kv, cfg: ModelConfig, ctx) -> tuple:
    """A prefill layer's post-RoPE (k, v) (``layers.attention_block``'s
    ``new_kv``: the rank's KV heads in 'head', every head in 'hd') -> the
    rank's shard of the decode buffer ``ctx`` lays out: its heads, or its
    head_dim slice of every head ('hd'), or with the cache's sequence over
    the model axis every head (the 'head' layout's gathered over ``model``)
    at its positions; over the data axes (a batch of one) its positions."""
    k, v = kv
    if ctx.tensor_parallel:
        over_model = ctx.cache_seq_over_model
        if over_model and ctx.kv_layout == "head":
            k, v = _tp().gather_over_model(k, ctx, 2), _tp().gather_over_model(v, ctx, 2)
        elif not over_model and ctx.kv_layout == "hd":
            w = cfg.head_dim // ctx.size
            k, v = k.narrow(-1, ctx.index * w, w), v.narrow(-1, ctx.index * w, w)
    k = _in_buffer(k, ctx.cache_len, ctx.ring_cache)
    v = _in_buffer(v, ctx.cache_len, ctx.ring_cache)
    if ctx.kv_seq_axes:
        start, stop = ctx.kv_seq_range()
        k, v = k[:, start:stop], v[:, start:stop]
    return k, v


def decode_layers(params: dict, token: torch.Tensor, pos, cfg: ModelConfig, layer_kv, *,
                  cache_index=None, kv_len=None, ring: bool = False,
                  group_rows: bool = False, ssm_cache: Optional[dict] = None,
                  encoder_out: Optional[torch.Tensor] = None, ctx=None) -> torch.Tensor:
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

    ``ctx``: one device by default. Tensor-parallel (a context made for a
    decode layout, ``sharding.specs.make_ctx(..., cache_len=)``; ``pos`` an
    int), ``params`` are the rank's shards, ``token`` (and ``encoder_out``)
    its data coordinate's rows, the caches its ``cache_specs`` shards
    (``cache_index`` and ``kv_len`` the whole cache's), and the logits the
    rank's (B, 1, Vp/m) vocab columns: the embedding vocab-parallel, Q/K/V
    column-parallel against the rank's cache shard
    (``layers.attention_block``), the row-parallel ``wo``, MLP, MoE block
    and SSM out-projection each closed by one reduce over ``model`` (the
    residual of one position is never sequence-sharded), the SSM step on
    the rank's heads (``ssm.ssm_decode_step``); a sub-block the axis leaves
    whole computes whole and closes with no reduce. On a mesh without a
    model split (``ctx.mesh_cache``) each rank steps its rows on the
    one-device model; with the cache's sequence over the data axes every
    rank attends over its positions and the softmax is merged over them.
    """
    if ctx is not None and (ctx.tensor_parallel or ctx.mesh_cache):
        if isinstance(pos, torch.Tensor) and pos.dim() == 1:
            raise NotImplementedError("a decode on a mesh steps every row at one "
                                      "position; per-row positions are single-device")
        ctx = dataclasses.replace(ctx, seq_shard=False)
    x = _embed(params, token, cfg, ctx)
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
            cross_kv=encoder_out if "cross" in layer else None, ctx=ctx)
        if new_ssm is not None:
            states.append(new_ssm)
    if states:
        ssm_cache.update(_stack_states(states))
    return _logits(params, x, cfg, ctx)


def _check_rank_cache(cache: dict, cfg: ModelConfig, ctx) -> None:
    """The cache a tensor-parallel decode is given is the rank's
    ``cache_specs`` shard, leaf by leaf: a whole cache raises."""
    from repro_torch.sharding.specs import held_cache_shapes

    got = held_cache_shapes(cache)
    if got != ctx.cache_shapes:
        raise ValueError(f"{cfg.name}: the cache's shapes {got} are not the rank's "
                         f"cache_specs shard {ctx.cache_shapes}")


def decode_step(params: dict, token: torch.Tensor, cache: dict, pos, cfg: ModelConfig, *,
                ring_cache: bool = False, encoder_out: Optional[torch.Tensor] = None,
                ctx=None):
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

    ``ctx``: tensor-parallel, a context made for the cache's decode layout
    (``sharding.specs.make_ctx(..., cache_len=, ring_cache=)``, ``T`` its
    ``cache_len``, the ring its ``ring_cache``: the argument is one
    device's) and ``cache`` the rank's shard of it (:func:`init_cache`
    with the context, or ``model.prefill``'s); see :func:`decode_layers`.
    The token's K/V are written by the rank that holds position ``pos``
    (``pos % T``) of the cache's sequence. The logits are the rank's vocab
    columns (``tensor_parallel.gather_cols`` joins them).
    """
    kv = cache.get("kv")
    cache_index = kv_len = None
    tp = ctx is not None and (ctx.tensor_parallel or ctx.mesh_cache)
    if tp:
        _check_decode_ctx(cfg, ctx, rows=token.shape[0])
        _check_rank_cache(cache, cfg, ctx)
        ring_cache = ctx.ring_cache
    if ring_cache:
        if cfg.attention_pattern != "swa":
            raise ValueError("ring_cache requires a uniform sliding-window arch")
        cache_len = ctx.cache_len if tp else kv[0].shape[2]
        cache_index = pos % cache_len
        kv_len = (torch.clamp(pos + 1, max=cache_len) if isinstance(pos, torch.Tensor)
                  else min(pos + 1, cache_len))
    layer_kv = (lambda i: DenseKV(kv[0][i], kv[1][i])) if kv is not None else None
    logits = decode_layers(params, token, pos, cfg, layer_kv, cache_index=cache_index,
                           kv_len=kv_len, ring=ring_cache, ssm_cache=cache.get("ssm"),
                           encoder_out=encoder_out, ctx=ctx)
    return logits, cache
