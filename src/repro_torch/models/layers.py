"""Shared model layers, dense subset: RMSNorm, RoPE, GQA attention, gated MLPs.

Counterpart of ``repro/models/layers.py``. Attention in the reference is
plain jnp (an online softmax over KV blocks, ``layers.py:128``), not a
Pallas kernel, so it is plain PyTorch here: fp32 scores, the causal, window
and kv_len masks of ``_mask_scores``, softmax, fp32 accumulation, output in
the query dtype. The full softmax and the reference's online softmax are
the same function up to rounding order.
"""

from __future__ import annotations

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
    """s: (..., Sq, T); q_pos: (Sq,); k_pos: (T,)."""
    valid = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=s.device)
    if causal:
        valid &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        valid &= k_pos[None, :] > q_pos[:, None] - window
    if kv_len is not None:
        valid &= (k_pos < kv_len)[None, :]
    return torch.where(valid, s, torch.full_like(s, NEG_INF))


def attention(q, k, v, *, causal: bool = True, window=None, attn_softcap=None,
              kv_len=None) -> torch.Tensor:
    """GQA attention. q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd), Hq % Hkv == 0.

    Returns (B, Sq, Hq, hd) in q.dtype; scores and accumulation are fp32.
    """
    batch, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    groups = hq // hkv
    qg = q.reshape(batch, sq, hkv, groups, hd).to(torch.float32)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.to(torch.float32)) * hd ** -0.5
    if attn_softcap is not None:
        s = softcap(s, attn_softcap)
    q_pos = torch.arange(sq, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    s = _mask_scores(s, q_pos, k_pos, causal=causal, window=window, kv_len=kv_len)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v.to(torch.float32))
    return out.reshape(batch, sq, hq, hd).to(q.dtype)


def attention_block(x, params: dict, *, num_heads: int, num_kv_heads: int, head_dim: int,
                    positions, inv_freq, causal: bool = True, window=None,
                    attn_softcap=None, kv_len=None) -> torch.Tensor:
    """Self-attention sub-block: projections + RoPE + attention + out-proj.

    Heads are head-major columns, the reference's single-device layout; its
    'hd' layout, decode cache and cross-attention arguments belong to the
    distributed, serving and encoder-decoder slices and are not ported yet.
    """
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, num_heads, head_dim)
    k = (x @ params["wk"]).reshape(b, s, num_kv_heads, head_dim)
    v = (x @ params["wv"]).reshape(b, s, num_kv_heads, head_dim)
    if inv_freq is not None:
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
    out = attention(q, k, v, causal=causal, window=window, attn_softcap=attn_softcap,
                    kv_len=kv_len)
    return out.reshape(b, s, num_heads * head_dim) @ params["wo"]
