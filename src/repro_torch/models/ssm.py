"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) in PyTorch.

Counterpart of ``repro/models/ssm.py``, which is plain jnp, so this is plain
PyTorch. Training and prefill use the chunked SSD algorithm: the
within-chunk quadratic, attention-like term and each chunk's contribution
to the carried state are batched over all chunks at once, and only the
O(S / chunk) recurrence of the carried state runs chunk by chunk, as the
reference's ``lax.scan`` does (the same products and sums per chunk, so the
same function up to rounding order). Decode is the O(1) recurrent update.

Layer structure (Mamba2, as the reference): separate projections
``[z, x, B, C, dt]``; causal depthwise conv (+ silu) on x, B and C;
``dt = softplus(dt + dt_bias)``; ``A = -exp(A_log)`` per head;
``y = SSD(x, dt, A, B, C) + D * x``; ``y = RMSNorm(y * silu(z))``;
``out_proj``. ngroups = 1: B and C are shared by every head.

``softplus``: the reference's ``jax.nn.softplus`` has no threshold; torch's
returns its input past 20, where the two differ by ``log1p(exp(-x))`` <
2.1e-9, under half an fp32 ulp of x (1.9e-6 at 20), so the rounded results
are the same.

Decode state: ``{"h": (B, H, P, N) fp32, "conv_x": (B, K-1, d_inner),
"conv_b", "conv_c": (B, K-1, N)}``, the last K-1 raw (pre-conv) inputs.
:func:`ssm_decode_step` returns new state tensors and leaves the given ones
as they were (the reference's functional update): the conv windows take
the dtype of ``concat(window, input)``, so a bf16 window from
``init_cache`` becomes fp32 after a step of an fp32 model, as in the
reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm


class SSMDims(NamedTuple):
    d_model: int
    d_inner: int
    num_heads: int
    head_dim: int
    state_size: int
    conv_kernel: int = 4


def make_dims(d_model: int, state_size: int, head_dim: int = 64, expand: int = 2) -> SSMDims:
    d_inner = expand * d_model
    assert d_inner % head_dim == 0
    return SSMDims(d_model=d_model, d_inner=d_inner, num_heads=d_inner // head_dim,
                   head_dim=head_dim, state_size=state_size)


def init_ssm_params(gen: torch.Generator, dims: SSMDims, *, lead: tuple = (), device="cuda",
                    dtype=torch.float32) -> dict:
    """One SSM layer's parameters, or ``lead``-stacked layers (``lead=(L,)``).

    The reference's law: N(0, 0.02) matrices and conv filters, zero conv
    biases, ``A_log = log(linspace(1, 16, H))``, ``D`` ones, ``dt_bias``
    zeros, ``gate_norm`` ones; the random draws come from ``gen``.
    """
    def dense(*shape):
        return (0.02 * torch.randn((*lead, *shape), generator=gen, device=device,
                                   dtype=torch.float32)).to(dtype)

    def const(values):
        return values.to(device=device, dtype=dtype).expand(*lead, *values.shape).clone()

    zeros = lambda n: const(torch.zeros(n))
    ones = lambda n: const(torch.ones(n))
    d, di, h, n, k = dims.d_model, dims.d_inner, dims.num_heads, dims.state_size, dims.conv_kernel
    return {
        "wz": dense(d, di),
        "wx": dense(d, di),
        "wb": dense(d, n),
        "wc": dense(d, n),
        "wdt": dense(d, h),
        "conv_x": dense(k, di),
        "conv_x_bias": zeros(di),
        "conv_b": dense(k, n),
        "conv_b_bias": zeros(n),
        "conv_c": dense(k, n),
        "conv_c_bias": zeros(n),
        "A_log": const(torch.log(torch.linspace(1.0, 16.0, h))),
        "D": ones(h),
        "dt_bias": zeros(h),
        "gate_norm": ones(di),
        "out_proj": dense(di, d),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv + silu. x: (B, S, C); w: (K, C)."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + b)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., L) -> (..., L, L) with S[i, j] = sum_{k=j+1..i} x_k (i >= j)."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, torch.full_like(diff, -math.inf))


def ssd_chunked(x, dt, a, b_mat, c_mat, *, chunk: int = 128,
                initial_state: Optional[torch.Tensor] = None):
    """Chunked SSD. x (B, S, H, P), dt (B, S, H) post-softplus, a (H,)
    negative, b_mat / c_mat (B, S, N). Returns (y (B, S, H, P), final state
    (B, H, P, N)), fp32 inside and out.

    The chunk is ``min(chunk, S)``, and ``gcd(S, chunk)`` when that does not
    divide S (the reference's rule: a prompt of 1100 runs chunks of 4).
    """
    bsz, seq, nh, hp = x.shape
    n = b_mat.shape[-1]
    chunk = min(chunk, seq)
    if seq % chunk:
        chunk = math.gcd(seq, chunk)
    nc = seq // chunk

    f32 = torch.float32
    x, dt, b_mat, c_mat, a = (t.to(f32) for t in (x, dt, b_mat, c_mat, a))
    xd = x * dt[..., None]                        # dt-discretized input
    da = dt * a                                   # (B, S, H)

    def to_chunks(t):
        return t.reshape(bsz, nc, chunk, *t.shape[2:])

    xd_c, da_c, b_c, c_c = map(to_chunks, (xd, da, b_mat, c_mat))
    da_cum = torch.cumsum(da_c, dim=2)            # (B, nc, cl, H)
    # Within-chunk (attention-like) term, every chunk at once.
    lmat = torch.exp(_segsum(da_c.movedim(-1, 2)))                    # (B, nc, H, cl, cl)
    cb = torch.einsum("bcln,bcsn->bcls", c_c, b_c)
    y_diag = torch.einsum("bchls,bcshp->bclhp", cb[:, :, None] * lmat, xd_c)
    # Each chunk's own contribution to the state it hands on.
    decay_states = torch.exp(da_cum[:, :, -1:, :] - da_cum)           # (B, nc, cl, H)
    states = torch.einsum("bcsn,bcshp->bchpn", b_c, xd_c * decay_states[..., None])
    chunk_decay = torch.exp(da_cum[:, :, -1, :])                      # (B, nc, H)
    # The carried state, chunk by chunk (the reference's scan carry).
    h = (initial_state.to(f32) if initial_state is not None
         else torch.zeros((bsz, nh, hp, n), dtype=f32, device=x.device))
    h_prev = []
    for k in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, k, :, None, None] + states[:, k]
    h_prev = torch.stack(h_prev, dim=1)                               # (B, nc, H, P, N)
    y_off = torch.einsum("bcln,bchpn->bclhp", c_c, h_prev) * torch.exp(da_cum)[..., None]
    y = (y_diag + y_off).reshape(bsz, seq, nh, hp)
    return y, h


def _project(x, params):
    return (x @ params["wz"], x @ params["wx"], x @ params["wb"], x @ params["wc"],
            x @ params["wdt"])


def _dt_a(dt, params):
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"].to(torch.float32))
    return dt, -torch.exp(params["A_log"].to(torch.float32))


def _gated_norm_tp(y: torch.Tensor, weight: torch.Tensor, d_inner: int, ctx,
                   eps: float = 1e-6) -> torch.Tensor:
    """:func:`layers.rms_norm` over the whole ``d_inner`` of a rank's slice
    ``y`` (..., d_inner/m): the sum of squares summed over ``model``
    (``tensor_parallel.sum_over_model``), the rank's slice of the replicated
    ``weight``."""
    from repro_torch.distributed import tensor_parallel

    dtype = y.dtype
    y = y.to(torch.float32)
    var = tensor_parallel.sum_over_model(torch.sum(y * y, dim=-1, keepdim=True), ctx) / d_inner
    w = weight.narrow(-1, ctx.index * y.shape[-1], y.shape[-1])
    return (y * torch.rsqrt(var + eps) * w.to(torch.float32)).to(dtype)


def ssm_forward(x: torch.Tensor, params: dict, dims: SSMDims, *, chunk: int = 128,
                initial_state: Optional[torch.Tensor] = None, return_state: bool = False,
                ctx=None):
    """Training/prefill pass. x: (B, S, D) -> (B, S, D) [, decode state].

    The returned state holds the final SSD state and the last K-1 raw
    inputs of each conv, in the projections' dtype (the model's).

    ``ctx`` (``sharding.specs.ShardCtx``; None where the model axis leaves
    ``d_inner`` whole, ``ShardCtx.ssm_whole``: every weight and the gated
    norm whole, no collective): tensor-parallel, ``x`` is the
    whole (sequence-gathered) input and ``params`` the rank's
    ``param_specs`` shards: ``z``, ``x`` and the conv on ``x`` are the
    rank's ``d_inner`` columns, ``B`` and ``C`` whole. With the heads split
    (``sharding.specs.ssm_heads_split``: the shards hold the rank's share of
    them) ``dt`` is the rank's heads and the SSD runs on them alone. With
    the heads whole (their count does not divide the model axis, as hymba's
    50 on model 4, 8 or 16: the shards hold every head) the rank gathers the
    convolved ``x`` over ``model`` (``tensor_parallel.gather_cols``,
    reduce-scattered in the backward), takes ``dt`` from the whole ``wdt``,
    runs the SSD and ``D * x`` on every head and keeps its own ``d_inner``
    columns of ``y``, cut where the head reshape is undone: a rank's columns
    may end inside a head (800 a rank at model=4 are 12.5 heads of 64).
    That is the reference's placement under GSPMD; the SSD then runs ``m``
    times over, once on each rank, and a rank's gradients of ``wdt``,
    ``A_log``, ``D`` and ``dt_bias`` come from its columns only
    (``tensor_parallel.grad_is_partial`` sums them over ``model``). Either
    way the gated norm runs over the whole ``d_inner``
    (:func:`_gated_norm_tp`) and the output is the rank's partial sum of
    ``out_proj``, which the caller reduces. The state it returns (prefill)
    is the rank's ``sharding.specs.cache_specs`` shard: ``h`` of its heads
    (every head where they stay whole), ``conv_x`` its ``d_inner`` columns
    (every column where the heads stay whole: the last K-1 raw inputs
    gathered over ``model``), ``conv_b``/``conv_c`` whole.
    """
    bsz, seq, _ = x.shape
    tp = ctx is not None and ctx.tensor_parallel
    heads = params["A_log"].shape[-1]      # the rank's heads (all on one device)
    z, xs_raw, b_raw, c_raw, dt = _project(x, params)
    xs = _causal_conv(xs_raw, params["conv_x"], params["conv_x_bias"])
    b_mat = _causal_conv(b_raw, params["conv_b"], params["conv_b_bias"])
    c_mat = _causal_conv(c_raw, params["conv_c"], params["conv_c_bias"])
    cols = xs.shape[-1]                    # the rank's d_inner columns
    whole_heads = tp and heads == dims.num_heads
    if whole_heads:
        from repro_torch.distributed import tensor_parallel

        xs = tensor_parallel.gather_cols(xs, ctx)
    dt, a = _dt_a(dt, params)
    xh = xs.reshape(bsz, seq, heads, dims.head_dim)
    y, h_final = ssd_chunked(xh, dt, a, b_mat, c_mat, chunk=chunk, initial_state=initial_state)
    y = y + params["D"].to(torch.float32)[None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(bsz, seq, heads * dims.head_dim)
    if whole_heads:
        y = y.narrow(-1, ctx.index * cols, cols)
    y = y.to(x.dtype) * F.silu(z)
    if tp:
        y = _gated_norm_tp(y, params["gate_norm"], dims.d_inner, ctx)
    else:
        y = rms_norm(y, params["gate_norm"])
    out = y @ params["out_proj"]
    if return_state:
        kk = dims.conv_kernel - 1
        conv_x = xs_raw[:, -kk:, :]
        if whole_heads:
            conv_x = tensor_parallel.gather_cols(conv_x, ctx)
        return out, {"h": h_final, "conv_x": conv_x, "conv_b": b_raw[:, -kk:, :],
                     "conv_c": c_raw[:, -kk:, :]}
    return out


def init_decode_state(bsz: int, dims: SSMDims, dtype=torch.float32, device="cuda") -> dict:
    kk = dims.conv_kernel - 1
    return {
        "h": torch.zeros((bsz, dims.num_heads, dims.head_dim, dims.state_size),
                         dtype=torch.float32, device=device),
        "conv_x": torch.zeros((bsz, kk, dims.d_inner), dtype=dtype, device=device),
        "conv_b": torch.zeros((bsz, kk, dims.state_size), dtype=dtype, device=device),
        "conv_c": torch.zeros((bsz, kk, dims.state_size), dtype=dtype, device=device),
    }


def _conv_step(window, new, w, b):
    """window: (B, K-1, C) past raw inputs; new: (B, C). Returns (out, window').

    ``torch.cat`` promotes as ``jnp.concatenate`` does, so a bf16 window
    beside an fp32 input gives an fp32 window.
    """
    full = torch.cat([window, new[:, None, :]], dim=1)          # (B, K, C)
    out = F.silu((full * w).sum(dim=1) + b)
    return out, full[:, 1:, :]


def ssm_decode_step(x: torch.Tensor, state: dict, params: dict, dims: SSMDims, ctx=None):
    """One-token recurrent update. x: (B, 1, D) -> ((B, 1, D), new state).

    ``ctx``: tensor-parallel, ``x`` is the whole input, ``params`` and
    ``state`` the rank's shards (``sharding.specs.cache_specs``), as in
    :func:`ssm_forward`: with the heads split the rank steps its heads and
    ``d_inner`` columns; with the heads whole it gathers the raw ``x`` of
    the token over ``model`` for the whole conv window, convolves its
    columns, gathers them, steps every head and keeps its columns of ``y``.
    Either way the gated norm sums its statistic over ``model`` and the
    output is the rank's partial sum of ``out_proj``.
    """
    bsz = x.shape[0]
    tp = ctx is not None and ctx.tensor_parallel
    heads = params["A_log"].shape[-1]      # the rank's heads (all on one device)
    z, xs_raw, b_raw, c_raw, dt = _project(x[:, 0, :], params)
    cols = xs_raw.shape[-1]                # the rank's d_inner columns
    whole_heads = tp and heads == dims.num_heads
    if whole_heads:
        from repro_torch.distributed import tensor_parallel

        window = state["conv_x"]
        xs, _ = _conv_step(window.narrow(-1, ctx.index * cols, cols), xs_raw,
                           params["conv_x"], params["conv_x_bias"])
        conv_x = torch.cat([window, tensor_parallel.gather_cols(xs_raw, ctx)[:, None, :]],
                           dim=1)[:, 1:, :]
        xs = tensor_parallel.gather_cols(xs, ctx)
    else:
        xs, conv_x = _conv_step(state["conv_x"], xs_raw, params["conv_x"],
                                params["conv_x_bias"])
    b_mat, conv_b = _conv_step(state["conv_b"], b_raw, params["conv_b"], params["conv_b_bias"])
    c_mat, conv_c = _conv_step(state["conv_c"], c_raw, params["conv_c"], params["conv_c_bias"])
    dt, a = _dt_a(dt, params)
    xh = xs.reshape(bsz, heads, dims.head_dim).to(torch.float32)
    decay = torch.exp(dt * a)                                     # (B, H)
    h = state["h"] * decay[..., None, None] + torch.einsum(
        "bn,bhp->bhpn", b_mat.to(torch.float32), xh * dt[..., None])
    y = torch.einsum("bn,bhpn->bhp", c_mat.to(torch.float32), h)
    y = y + params["D"].to(torch.float32)[None, :, None] * xh
    y = y.reshape(bsz, heads * dims.head_dim)
    if whole_heads:
        y = y.narrow(-1, ctx.index * cols, cols)
    y = y.to(x.dtype) * F.silu(z)
    if tp:
        y = _gated_norm_tp(y, params["gate_norm"], dims.d_inner, ctx)
    else:
        y = rms_norm(y, params["gate_norm"])
    out = (y @ params["out_proj"])[:, None, :]
    return out, {"h": h, "conv_x": conv_x, "conv_b": conv_b, "conv_c": conv_c}
