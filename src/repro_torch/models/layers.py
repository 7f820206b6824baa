"""Shared model layers: RMSNorm, RoPE, GQA attention, gated MLPs.

Counterpart of ``repro/models/layers.py``. Attention in the reference is
plain jnp (an online softmax over KV blocks, ``layers.py:128``), not a
Pallas kernel, so it is plain PyTorch here: fp32 scores, the causal, window
and kv_len masks of ``_mask_scores``, softmax, fp32 accumulation, output in
the query dtype. The full softmax and the reference's online softmax are
the same function up to rounding order; for one query (decode) the
reference computes this full softmax too (``_decode_attention``). Query
positions and KV lengths may be given per row, so one batched decode serves
slots at different positions.
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


def _mask_scores(s, q_pos, k_pos, *, causal: bool, window, kv_len):
    """s: (B, Hkv, G, Sq, T); q_pos: (Sq,), or (B, Sq) per row; k_pos: (T,);
    kv_len: None, an int, or (B,) per row."""
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
    return torch.where(valid, s, torch.full_like(s, NEG_INF))


def attention(q, k, v, *, causal: bool = True, window=None, attn_softcap=None,
              q_offset=0, kv_len=None) -> torch.Tensor:
    """GQA attention. q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd), Hq % Hkv == 0.

    ``q_offset`` is the position of the first query (an int, or a (B,)
    tensor of per-row positions, as a batched decode over slots at
    different positions gives); ``kv_len`` masks keys at and past it (an
    int or (B,)). Returns (B, Sq, Hq, hd) in q.dtype; scores and
    accumulation are fp32.
    """
    batch, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    groups = hq // hkv
    qg = q.reshape(batch, sq, hkv, groups, hd).to(torch.float32)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.to(torch.float32)) * hd ** -0.5
    if attn_softcap is not None:
        s = softcap(s, attn_softcap)
    if isinstance(q_offset, torch.Tensor):  # (B,) per-row positions
        q_pos = q_offset[:, None] + torch.arange(sq, device=q.device)
    else:
        q_pos = torch.arange(q_offset, q_offset + sq, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    s = _mask_scores(s, q_pos, k_pos, causal=causal, window=window, kv_len=kv_len)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v.to(torch.float32))
    return out.reshape(batch, sq, hq, hd).to(q.dtype)


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


def attention_block(x, params: dict, *, num_heads: int, num_kv_heads: int, head_dim: int,
                    positions, inv_freq, causal: bool = True, window=None,
                    attn_softcap=None, kv_cache=None, cache_index=None, kv_len=None):
    """Self-attention sub-block: projections + RoPE + attention + out-proj.

    Returns ``(out, new_kv)``. Without a cache ``new_kv`` is the post-RoPE
    ``(k, v)``, the content prefill builds its cache from. With ``kv_cache``
    (a :class:`DenseKV`, or the serving path's paged layer view, which has
    the same ``write``) the fresh K/V are written at ``cache_index`` (an int
    or (B,) per-row positions) in the cache's dtype, attention runs over the
    whole cache from query position ``cache_index``, keys at and past
    ``kv_len`` masked (``cache_index + Sq`` unless given: the reference's
    override, which its ring cache sets to the ring's fill), and ``new_kv``
    is what was attended over. Heads are head-major columns, the reference's single-device
    layout; its 'hd' layout and cross-attention belong to the distributed
    and encoder-decoder slices and are not ported yet.
    """
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, num_heads, head_dim)
    k = (x @ params["wk"]).reshape(b, s, num_kv_heads, head_dim)
    v = (x @ params["wv"]).reshape(b, s, num_kv_heads, head_dim)
    if inv_freq is not None:
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
    new_kv = (k, v)
    q_offset = 0
    if kv_cache is not None:
        k, v = new_kv = kv_cache.write(k, v, cache_index)
        q_offset = cache_index
        kv_len = cache_index + s if kv_len is None else kv_len
    out = attention(q, k, v, causal=causal, window=window, attn_softcap=attn_softcap,
                    q_offset=q_offset, kv_len=kv_len)
    return out.reshape(b, s, num_heads * head_dim) @ params["wo"], new_kv
