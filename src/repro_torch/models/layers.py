"""Shared model layers: RMSNorm, RoPE, sinusoidal positions, GQA attention
(self and cross), gated MLPs.

Counterpart of ``repro/models/layers.py``. Attention in the reference is
plain jnp (``flash_attention``, an online softmax over KV blocks), not a
Pallas kernel, so it is plain PyTorch here, with the reference's numerics
at the reference's memory: for more than one query the keys are scanned in
blocks of ``block_k`` with a running max, sum and accumulator in fp32, so
the fp32 scores of one block exist at a time, never the whole
``(B, Hkv, G, Sq, T)``; for one query (decode) the whole softmax at once,
the reference's ``_decode_attention``. The causal, window and kv_len masks
are ``_mask_scores``'s; the output takes the query dtype. Query positions
and KV lengths may be given per row, so one batched decode serves slots at
different positions. A tensor-parallel decode attends against the rank's
shard of the cache (``_cached_attention_tp``); where that shard holds a
slice of the cache's positions, each rank's softmax over its keys
(``_partial_attention``) is merged across the ranks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)).to(dtype)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with JAX's promotion: mixed float dtypes compute in the wider.

    The reference's whisper encoder feeds fp32 frames through bf16 weights
    in bf16 training, so its encoder and cross-attention K/V run in fp32;
    torch refuses a product of mixed dtypes.
    """
    if x.dtype != w.dtype:
        dtype = torch.promote_types(x.dtype, w.dtype)
        return x.to(dtype) @ w.to(dtype)
    return x @ w


def swiglu(x, wi, wg, wo):
    return (F.silu(x @ wg) * (x @ wi)) @ wo


def geglu(x, wi, wg, wo):
    return (F.gelu(x @ wg, approximate="tanh") * (x @ wi)) @ wo


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair RoPE. x: (B, S, H, hd); positions: (S,) or (B, S)."""
    dtype = x.dtype
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(torch.float32) * inv_freq  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x = x.to(torch.float32)
    shape = x.shape
    x = x.reshape(*shape[:-1], shape[-1] // 2, 2)
    x1, x2 = x[..., 0], x[..., 1]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(shape)
    return out.to(dtype)


def sinusoidal_positions(num_positions: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal absolute position embeddings, (num_positions, dim) fp32."""
    return sinusoidal_at(torch.arange(num_positions, device=device), dim)


def sinusoidal_at(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """The rows ``positions`` (any shape) of :func:`sinusoidal_positions`'s
    table, computed alone: (*positions.shape, dim), the same values."""
    pos = positions.to(torch.float32)[..., None]
    # fp32 throughout, as the reference: -log(1e4) rounded to fp32 first.
    log_base = torch.log(torch.tensor(10000.0, dtype=torch.float32, device=positions.device))
    inv = torch.exp(-log_base * torch.arange(
        0, dim, 2, dtype=torch.float32, device=positions.device) / dim)
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


FLASH_BLOCK_K = 1024   # the reference's default KV block (its ShardCtx.flash_block_k)


def _mask_scores(s, q_pos, k_pos, *, causal: bool, window, kv_len):
    """s: (B, Hkv, G, Sq, T); q_pos: (Sq,), or (B, Sq) per row; k_pos: (T,);
    kv_len: None, an int, or (B,) per row. Masked scores become NEG_INF."""
    if not causal and window is None and kv_len is None:
        return s
    q = q_pos[..., :, None]
    valid = torch.ones((*q_pos.shape, k_pos.shape[0]), dtype=torch.bool, device=s.device)
    if causal:
        valid &= k_pos <= q
    if window is not None:
        # Attend to at most `window` previous positions (inclusive of self).
        valid &= k_pos > q - window
    if kv_len is not None:
        if isinstance(kv_len, torch.Tensor) and kv_len.dim() == 1:
            kv_len = kv_len[:, None, None]
        valid &= k_pos < kv_len
    if valid.dim() == 3:  # per-row positions: (B, Sq, T) -> (B, 1, 1, Sq, T)
        valid = valid[:, None, None]
    return s.masked_fill(~valid, NEG_INF)


def _query_positions(q_offset, sq: int, device) -> torch.Tensor:
    """(Sq,) positions from an int offset, (B, Sq) from a (B,) tensor."""
    if isinstance(q_offset, torch.Tensor):  # (B,) per-row positions
        return q_offset[:, None] + torch.arange(sq, device=device)
    return torch.arange(q_offset, q_offset + sq, device=device)


def _direct_attention(q, k, v, *, causal=True, window=None, attn_softcap=None, q_offset=0,
                      kv_len=None) -> torch.Tensor:
    """The whole softmax at once, the reference's ``_decode_attention``: the
    (B, Hkv, G, Sq, T) fp32 scores of every key. :func:`attention` runs it
    for one query."""
    batch, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    groups = hq // hkv
    qg = q.reshape(batch, sq, hkv, groups, hd).to(torch.float32)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.to(torch.float32)) * hd ** -0.5
    if attn_softcap is not None:
        s = softcap(s, attn_softcap)
    s = _mask_scores(s, _query_positions(q_offset, sq, q.device),
                     torch.arange(skv, device=q.device), causal=causal, window=window,
                     kv_len=kv_len)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v.to(torch.float32))
    return out.reshape(batch, sq, hq, hd).to(q.dtype)


def attention(q, k, v, *, causal: bool = True, window=None, attn_softcap=None,
              q_offset=0, kv_len=None, block_k: int = FLASH_BLOCK_K) -> torch.Tensor:
    """GQA attention. q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd), Hq % Hkv == 0.

    ``q_offset`` is the position of the first query (an int, or a (B,)
    tensor of per-row positions, as a batched decode over slots at
    different positions gives); ``kv_len`` masks keys at and past it (an
    int or (B,)). Returns (B, Sq, Hq, hd) in q.dtype; scores and
    accumulation are fp32.

    One query runs :func:`_direct_attention`. More run the reference's
    ``flash_attention``: K/V padded to a multiple of ``min(block_k, Skv)``
    (the padded keys masked through ``kv_len``), then one block at a time
    the scores, the running max ``m``, the rescaling ``exp(m_prev - m_new)``
    of the running sum ``l`` and of the accumulator, in that order, and
    ``acc / max(l, 1e-30)`` at the end. No block is skipped: a row whose
    leading blocks are all masked (a window, a ``kv_len`` cut) keeps ``m``
    at NEG_INF there and sums ``exp(0)``, and its first block with a valid
    key rescales that by ``exp(NEG_INF - m_new)``, exactly 0, as in the
    reference. Under autograd each block's scores stay for the backward, as
    the reference's ``jax.grad`` of its scan keeps them.
    """
    batch, sq, hq, hd = q.shape
    if sq == 1:
        return _direct_attention(q, k, v, causal=causal, window=window,
                                 attn_softcap=attn_softcap, q_offset=q_offset, kv_len=kv_len)
    skv, hkv = k.shape[1], k.shape[2]
    groups = hq // hkv
    block_k = min(block_k, skv)
    k, v = k.to(torch.float32), v.to(torch.float32)
    if skv % block_k:
        pad = block_k - skv % block_k
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_len = (torch.clamp(kv_len, max=skv) if isinstance(kv_len, torch.Tensor)
                  else skv if kv_len is None else min(kv_len, skv))
    # Queries (B, Hkv, G*Sq, hd); keys (B, Hkv, hd, T) and values (B, Hkv, T, hd).
    qg = q.reshape(batch, sq, hkv, groups, hd).permute(0, 2, 3, 1, 4).to(torch.float32)
    qg = qg.reshape(batch, hkv, groups * sq, hd)
    kt, vt = k.permute(0, 2, 3, 1), v.permute(0, 2, 1, 3)
    q_pos = _query_positions(q_offset, sq, q.device)
    rows = (batch, hkv, groups, sq)
    m = torch.full(rows, NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(rows, dtype=torch.float32, device=q.device)
    acc = torch.zeros((*rows, hd), dtype=torch.float32, device=q.device)
    for start in range(0, k.shape[1], block_k):
        blk = slice(start, start + block_k)
        s = (qg @ kt[..., blk]).view(*rows, block_k) * hd ** -0.5
        if attn_softcap is not None:
            s = softcap(s, attn_softcap)
        s = _mask_scores(s, q_pos, torch.arange(start, start + block_k, device=q.device),
                         causal=causal, window=window, kv_len=kv_len)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pv = p.view(batch, hkv, groups * sq, block_k) @ vt[:, :, blk]
        acc = acc * corr[..., None] + pv.view(*rows, hd)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]                  # (B, Hkv, G, Sq, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(batch, sq, hq, hd).to(q.dtype)


class DenseKV(NamedTuple):
    """One layer's dense decode buffers, k and v of shape (B, T, Hkv, hd).

    :meth:`write` stores fresh K/V in place, so a decode step costs no copy
    of the cache; the reference's functional ``dynamic_update_slice`` gives
    the same values.
    """

    k: torch.Tensor
    v: torch.Tensor

    def write(self, k, v, index):
        """Write (B, Sq, Hkv, hd) ``k``/``v`` at ``index`` (an int, or (B,)
        per-row positions with Sq == 1), cast to the cache dtype first;
        returns the buffers to attend over."""
        if isinstance(index, torch.Tensor) and index.dim() == 1:
            rows = torch.arange(k.shape[0], device=k.device)
            self.k[rows, index] = k[:, 0].to(self.k.dtype)
            self.v[rows, index] = v[:, 0].to(self.v.dtype)
        else:
            self.k[:, index:index + k.shape[1]] = k.to(self.k.dtype)
            self.v[:, index:index + v.shape[1]] = v.to(self.v.dtype)
        return self.k, self.v


def split_heads(t: torch.Tensor, n_heads: int, head_dim: int, layout: str) -> torch.Tensor:
    """(B, S, n*hd) -> (B, S, n, hd), the reference's ``split_heads``.

    layout='head': the columns are head-major (the standard order).
    layout='hd': head_dim-major, the order in which a head count that does
    not divide the model axis shards on head_dim (``sharding/specs.py``).
    """
    b, s, _ = t.shape
    if layout == "hd":
        return t.reshape(b, s, head_dim, n_heads).transpose(2, 3)
    return t.reshape(b, s, n_heads, head_dim)


def merge_heads(t: torch.Tensor, layout: str) -> torch.Tensor:
    """Inverse of :func:`split_heads`: (B, S, n, hd) -> (B, S, n*hd)."""
    b, s, h, hd = t.shape
    if layout == "hd":
        return t.transpose(2, 3).reshape(b, s, hd * h)
    return t.reshape(b, s, h * hd)


def _kv_for_q_heads(k, v, num_heads: int, num_kv_heads: int, q_heads: int, ctx):
    """Every KV head (B, T, Hkv, hd) -> the KV head of each of a
    tensor-parallel rank's ``q_heads`` Q heads (Q in 'head'), one a Q head."""
    group = num_heads // num_kv_heads
    index = (ctx.index * q_heads + torch.arange(q_heads, device=k.device)) // group
    return k.index_select(2, index), v.index_select(2, index)


def _partial_attention(q, k, v, *, k_start: int, causal: bool, window, attn_softcap, q_offset,
                       kv_len):
    """:func:`_direct_attention`'s softmax over a shard of the keys, the
    ones at positions ``k_start ..`` of the whole cache: the running max
    ``m`` and sum ``l`` (B, Hkv, G, Sq) and the unnormalized accumulator
    (B, Hkv, G, Sq, hd), fp32, as :func:`attention`'s blocks keep them. A
    shard whose every key is masked has ``m`` at NEG_INF; the merge
    (``tensor_parallel.merge_softmax``) scales it by ``exp(NEG_INF - M)``,
    exactly 0."""
    batch, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(batch, sq, hkv, hq // hkv, hd).to(torch.float32)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.to(torch.float32)) * hd ** -0.5
    if attn_softcap is not None:
        s = softcap(s, attn_softcap)
    s = _mask_scores(s, _query_positions(q_offset, sq, q.device),
                     torch.arange(k_start, k_start + skv, device=q.device), causal=causal,
                     window=window, kv_len=kv_len)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bkgqt,btkd->bkgqd", p, v.to(torch.float32))
    return m, p.sum(dim=-1), acc


def _cached_attention_tp(x, params: dict, *, num_heads: int, num_kv_heads: int, head_dim: int,
                         positions, inv_freq, causal: bool, window, attn_softcap, kv_cache,
                         cache_index: int, kv_len, ctx) -> torch.Tensor:
    """One position's self-attention on a tensor-parallel rank against its
    shard of the decode cache (``sharding.specs.cache_specs``, laid out by
    ``ctx``); returns the rank's partial sum of the out-projection.

    * 'head': the rank's Q heads attend over its KV heads;
    * 'hd': the fresh K/V columns are gathered over ``model`` (every head's
      head_dim slices), RoPE'd, and the rank's slice written; then every
      rank gathers the cache's head_dim slices over ``model`` and attends
      over whole heads, as GSPMD does for the layout (Q in 'hd' gathered
      too, as in training);
    * the cache's sequence over ``model`` (kv_seq_shard): Q and the fresh
      K/V are gathered over ``model`` (every head), the rank attends over
      its positions of every head and keeps its Q columns of the output;
    * over the data axes (a batch of one): heads as above, the rank's
      positions;
    * K/V whole (no layout): the cache holds every KV head on every rank,
      and the rank's Q heads attend over theirs; Q whole too: every rank
      attends over every head with the whole ``wo``, and the output is
      whole, not a partial sum. On a mesh without a model split (``ctx``
      of size 1, its cache's sequence over the data axes) every rank
      computes the same Q and K/V and attends over its positions.

    With the sequence split the rank that holds ``cache_index`` writes the
    fresh K/V; each rank's softmax over its keys (positions offset by its
    shard's start in the masks) is merged over the split axes
    (``tensor_parallel.merge_softmax``): the direct softmax's result up to
    summation order.
    """
    from repro_torch.distributed import tensor_parallel as tp

    ql, kvl = ctx.q_layout, ctx.kv_layout
    over_model = ctx.cache_seq_over_model
    # Split columns gathered: every head's. Whole ones are every head's already.
    gather_q = (over_model and ql == "head") or ql == "hd"
    gather_kv = (over_model and kvl == "head") or kvl == "hd"
    q = linear(x, params["wq"])
    q_cols = q.shape[-1]
    k, v = linear(x, params["wk"]), linear(x, params["wv"])
    if gather_q:
        q = tp.gather_cols(q, ctx)
    if gather_kv:
        k, v = tp.gather_cols(k, ctx), tp.gather_cols(v, ctx)
    q = split_heads(q, q.shape[-1] // head_dim, head_dim, ql)
    k = split_heads(k, k.shape[-1] // head_dim, head_dim, kvl)
    v = split_heads(v, v.shape[-1] // head_dim, head_dim, kvl)
    if inv_freq is not None:
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
    hd_split = kvl == "hd" and not over_model
    if hd_split:  # the rank's head_dim slice of every head
        w = head_dim // ctx.size
        k, v = k.narrow(-1, ctx.index * w, w), v.narrow(-1, ctx.index * w, w)
    start, stop = ctx.kv_seq_range()
    if start <= cache_index < stop:
        kv_cache.write(k, v, cache_index - start)
    ck, cv = kv_cache.k, kv_cache.v
    if hd_split:
        ck, cv = tp.gather_over_model(ck, ctx, -1), tp.gather_over_model(cv, ctx, -1)
    if ctx.tensor_parallel and ql == "head" and kvl != "head" and not over_model:
        # The rank's Q heads against every KV head ('hd' gathered, or whole).
        ck, cv = _kv_for_q_heads(ck, cv, num_heads, num_kv_heads, q.shape[2], ctx)
    masks = dict(causal=causal, window=window, attn_softcap=attn_softcap, q_offset=cache_index,
                 kv_len=kv_len)
    if ctx.kv_seq_axes:
        out = tp.merge_softmax(*_partial_attention(q, ck, cv, k_start=start, **masks), ctx,
                               ctx.kv_seq_axes)                       # (B, Hkv, G, 1, hd)
        out = out.permute(0, 3, 1, 2, 4).reshape(q.shape).to(q.dtype)
    else:
        out = attention(q, ck, cv, **masks)
    out = merge_heads(out, ql)
    if gather_q:
        out = out.narrow(-1, ctx.index * q_cols, q_cols)
    return linear(out, params["wo"])


def attention_block(x, params: dict, *, num_heads: int, num_kv_heads: int, head_dim: int,
                    positions, inv_freq, causal: bool = True, window=None,
                    attn_softcap=None, kv_cache=None, cache_index=None, kv_len=None,
                    cross_kv=None, block_k: int = FLASH_BLOCK_K, ctx=None):
    """Attention sub-block: projections + RoPE + attention + out-proj.

    Returns ``(out, new_kv)``. Without a cache ``new_kv`` is the post-RoPE
    ``(k, v)``, the content prefill builds its cache from. With ``kv_cache``
    (a :class:`DenseKV`, or the serving path's paged layer view, which has
    the same ``write``) the fresh K/V are written at ``cache_index`` (an int
    or (B,) per-row positions) in the cache's dtype, attention runs over the
    whole cache from query position ``cache_index``, keys at and past
    ``kv_len`` masked (``cache_index + Sq`` unless given: the reference's
    override, which its ring cache sets to the ring's fill), and ``new_kv``
    is what was attended over.

    With ``cross_kv`` (B, S_enc, D) this is cross-attention (whisper's
    decoder): K/V come from the encoder output, with no RoPE, no causal
    mask and no cache. Mixed dtypes promote (:func:`linear`), as in the
    reference. ``block_k``: the KV block of :func:`attention` (the caller's
    ``ShardCtx.flash_block_k``).

    ``ctx`` (``sharding.specs.ShardCtx``, one device by default) gives the
    columns' head layouts (:func:`split_heads`). Tensor-parallel, ``x`` is
    the whole (sequence-gathered) input, ``wq``/``wk``/``wv`` are the
    rank's columns, ``wo`` its rows, and the output is the rank's partial
    sum of the out-projection, which the caller reduces. In the Q 'head'
    layout the columns are the rank's heads. In Q 'hd' they are its
    head_dim slice of every head: the rank gathers the Q columns over the
    model axis (``tensor_parallel.gather_cols``), attends over every head
    and keeps its own 'hd' slice of the merged output, the rows of ``wo``
    it holds. So every rank repeats the whole attention, as the layout
    implies: the reference's GSPMD gathers Q there too. K/V in 'hd' are
    gathered likewise (``new_kv`` then holds every head; with Q in 'head'
    each Q head attends over its KV head), and so are K/V that no layout
    splits (whole on every rank). With Q whole too (``ctx.attn_whole``)
    every rank computes the whole attention and the output is whole. With
    a ``kv_cache`` against a context's decode layout on a mesh
    (``ctx.mesh_cache``) the rank attends against its shard of the cache
    (:func:`_cached_attention_tp`) and ``new_kv`` is None.
    """
    b, s, _ = x.shape
    q_layout = "head" if ctx is None else ctx.q_layout
    kv_layout = "head" if ctx is None else ctx.kv_layout
    tp = ctx is not None and ctx.tensor_parallel
    if ctx is not None and ctx.mesh_cache and kv_cache is not None:
        return _cached_attention_tp(
            x, params, num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim,
            positions=positions, inv_freq=inv_freq, causal=causal, window=window,
            attn_softcap=attn_softcap, kv_cache=kv_cache, cache_index=cache_index,
            kv_len=cache_index + s if kv_len is None else kv_len, ctx=ctx), None
    kv_src = cross_kv if cross_kv is not None else x
    q = linear(x, params["wq"])
    q_cols = q.shape[-1]
    if tp and q_layout == "hd":
        from repro_torch.distributed import tensor_parallel

        q = tensor_parallel.gather_cols(q, ctx)
    q_heads = q.shape[-1] // head_dim
    q = split_heads(q, q_heads, head_dim, q_layout)
    k = linear(kv_src, params["wk"])
    v = linear(kv_src, params["wv"])
    if tp and kv_layout == "hd":  # every rank's head_dim-major columns: every head
        from repro_torch.distributed import tensor_parallel

        k, v = tensor_parallel.gather_cols(k, ctx), tensor_parallel.gather_cols(v, ctx)
    k = split_heads(k, k.shape[-1] // head_dim, head_dim, kv_layout)
    v = split_heads(v, v.shape[-1] // head_dim, head_dim, kv_layout)
    if inv_freq is not None and cross_kv is None:
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
    new_kv = (k, v)
    if tp and q_layout == "head" and kv_layout != "head":  # every KV head: 'hd' or whole
        k, v = _kv_for_q_heads(k, v, num_heads, num_kv_heads, q_heads, ctx)
    q_offset = 0
    if kv_cache is not None:
        k, v = new_kv = kv_cache.write(k, v, cache_index)
        q_offset = cache_index
        kv_len = cache_index + s if kv_len is None else kv_len
    out = merge_heads(attention(q, k, v, causal=causal and cross_kv is None, window=window,
                                attn_softcap=attn_softcap, q_offset=q_offset, kv_len=kv_len,
                                block_k=block_k),
                      q_layout)
    if tp and q_layout == "hd":
        out = out.narrow(-1, ctx.index * q_cols, q_cols)
    return linear(out, params["wo"]), new_kv
