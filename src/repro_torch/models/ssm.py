"""Mamba-2 / SSD (state-space duality) block — arXiv:2405.21060.

Training/prefill uses the chunked SSD algorithm (quadratic within a chunk,
linear across chunks); decode uses the O(1) recurrent state update, as the
reference's ``src/repro/models/ssm.py`` does. The scan runs in float32
whatever the activations' dtype.

The reference writes the chunk products as einsums of four and five
operands and leaves their contraction order to XLA; here each is a chain
of pairwise products in a stated order (``ssd_chunked``). With one B/C
group the C.B product is the same for every head and is taken once.
``jax.nn.softplus`` is ``logaddexp(x, 0)``: ``F.softplus`` switches to
``x`` above 20, so ``torch.logaddexp`` is used.

Under a step that splits its products over ``model`` (``parallel.fsdp``)
where the act rules split the SSD heads (``ssm_splits``), a rank computes
its own heads: their ``z`` and ``x`` channels, ``dt``, the depthwise conv
of its ``x`` channels, the scan, the skip term and the gate; B and C (one
group, read by every head) and their conv channels it computes whole.
``w_in`` fuses ``[z | x | B | C | dt]``, so its ``model`` block would cut
across the five parts: it is read whole (``gathered`` without ``keep``),
and so is ``conv_w`` (``[x | B | C]``), and the rank takes its columns of
them; their gradients are then partial sums over ``model``. ``norm`` and
``w_out``'s rows are head-major, and ``a_log``, ``dt_bias`` and
``d_skip`` are per head: those arrive as the rank's blocks (``KEPT``).
The gated RMSNorm takes its sum of squares over every channel, so a rank
adds its own over ``model`` (``split_rmsnorm``), and ``w_out``'s product
is the rank's partial sum, which the segment reduce-scatters or sums. In
a cache, the state's heads align with the rank's and are read and
written as its part (``kvcache.read_part`` / ``write_part``); the conv
window's ``model`` block cuts across x, B and C, so the rank reads the
whole window, and gathers its new x channels over ``model`` before it
writes its block of the new window.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, SSMConfig
from repro_torch.models.layers import causal_conv1d, rmsnorm
from repro_torch.parallel import fsdp, kvcache

#: the leaves a rank that splits the SSD heads reads as its ``model``
#: blocks: per head, or head-major channels (module docstring)
KEPT = ("a_log", "dt_bias", "d_skip", "norm", "w_out")


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def make_ssm(make, path: str, cfg: ModelConfig):
    c: SSMConfig = cfg.ssm
    d = cfg.d_model
    d_in = c.expand * d
    h = d_in // c.head_dim
    g = 1  # single B/C group
    n = c.state_dim
    conv_dim = d_in + 2 * g * n
    s = d ** -0.5
    return {
        # fused input projection: [z, x, B, C, dt]
        "w_in": make(f"{path}.w_in", (d, 2 * d_in + 2 * g * n + h),
                     ("embed", "mlp"), s),
        "conv_w": make(f"{path}.conv_w", (c.conv_width, conv_dim),
                       ("conv", "mlp"), 0.2),
        "a_log": make(f"{path}.a_log", (h,), ("heads",), init="zeros"),
        "dt_bias": make(f"{path}.dt_bias", (h,), ("heads",), init="zeros"),
        "d_skip": make(f"{path}.d_skip", (h,), ("heads",), init="ones"),
        "norm": make(f"{path}.norm", (d_in,), ("mlp",), init="zeros"),
        "w_out": make(f"{path}.w_out", (d_in, d), ("mlp", "embed"),
                      d_in ** -0.5),
    }


def _heads(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim


def ssm_splits(cfg: ModelConfig) -> bool:
    """Whether the current step splits the SSD heads over its split axis
    (``fsdp.splits``, the step's act rules with their divisibility
    fallback)."""
    return fsdp.splits("heads", _heads(cfg))


def gathered_ssm(params, split: bool):
    """An SSD layer's parameters as ``apply_ssm`` reads them: the ``KEPT``
    leaves as their ``model`` blocks where ``split``, every other leaf
    whole."""
    return {k: fsdp.gathered(v, keep=split and k in KEPT)
            for k, v in params.items()}


def split_rmsnorm(x, scale, width: int, eps: float = 1e-6):
    """``layers.rmsnorm`` of a ``width``-channel row of which ``x`` holds
    this rank's channels (``scale`` their block): the sum of squares is
    summed over the split axis, forward and backward
    (``fsdp.model_sum_shared``: a rank's gradient of it comes from its own
    channels only)."""
    dt = x.dtype
    x = x.float()
    total = fsdp.model_sum_shared(torch.sum(x * x, dim=-1, keepdim=True))
    out = x * torch.rsqrt(total / width + eps) * (1.0 + scale.float())
    return out.to(dt)


class SSMCache(NamedTuple):
    state: torch.Tensor   # (B, H, P, N) float32
    conv: torch.Tensor    # (B, K-1, conv_dim)


def init_ssm_cache(cfg: ModelConfig, batch: int, layers: int, dtype,
                   device) -> SSMCache:
    c = cfg.ssm
    d_in = c.expand * cfg.d_model
    h = d_in // c.head_dim
    conv_dim = d_in + 2 * c.state_dim
    return SSMCache(
        state=torch.zeros((layers, batch, h, c.head_dim, c.state_dim),
                          dtype=torch.float32, device=device),
        conv=torch.zeros((layers, batch, c.conv_width - 1, conv_dim),
                         dtype=dtype, device=device))


def _repeat_heads(x, rep: int, dim: int):
    """``jnp.repeat(x, rep, axis=dim)``: every entry of ``dim`` ``rep``
    times in a row (a view expanded, then one copy)."""
    shape = list(x.shape)
    shape.insert(dim + 1, rep)
    return x.unsqueeze(dim + 1).expand(shape).flatten(dim, dim + 1)


def _segsum(x):
    """x: (..., L) log-decays -> (..., L, L) lower-triangular cumulative
    sums, -inf above the diagonal (``exp`` maps it to 0)."""
    l = x.shape[-1]
    xx = x[..., None, :].expand(*x.shape, l).transpose(-1, -2)  # (.., out, in)
    ones = torch.ones((l, l), dtype=torch.bool, device=x.device)
    xx = torch.where(torch.tril(ones, diagonal=-1), xx, 0.0)
    out = torch.cumsum(xx, dim=-2)
    return torch.where(torch.tril(ones), out, float("-inf"))


def ssd_chunked(x, dt, a, b, c, chunk: int,
                initial_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x: (B,L,H,P)  dt: (B,L,H)  a: (H,) negative reals
    b, c: (B,L,G,N) with H % G == 0.
    Returns (y (B,L,H,P), final_state (B,H,P,N)).

    The products, in order (z chunks, l/s positions in a chunk):
      y_diag[l] = sum_s ((C_l . B_s) * exp(segsum)[l, s] * dt_s) x_s
      states    = sum_s (x_s * (exp(cum_last - cum_s) * dt_s)) B_s
      y_off[l]  = (C_l . prev_state) * exp(cum_l)
    """
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    nc = l // chunk
    if nc * chunk != l:
        raise AssertionError("seq must be divisible by ssd chunk")

    xs = x.reshape(bsz, nc, chunk, h, p)
    dts = dt.reshape(bsz, nc, chunk, h)
    # (B,NC,G,CL,N): the heads of a group share these
    bs = b.reshape(bsz, nc, chunk, g, n).permute(0, 1, 3, 2, 4)
    cs = c.reshape(bsz, nc, chunk, g, n).permute(0, 1, 3, 2, 4)

    da = dts * a[None, None, None, :]              # (B,NC,CL,H) log-decay
    da_h = da.movedim(-1, 2)                       # (B,NC,H,CL)
    cum = torch.cumsum(da_h, dim=-1)
    dt_h = dts.movedim(-1, 2)                      # (B,NC,H,CL)
    xh = xs.permute(0, 1, 3, 2, 4)                 # (B,NC,H,CL,P)

    # intra-chunk (quadratic within chunk)
    ll = torch.exp(_segsum(da_h))                  # (B,NC,H,CL,CL)
    cb = torch.matmul(cs, bs.transpose(-1, -2))    # (B,NC,G,CL,CL)
    cb = _repeat_heads(cb, rep, 2)          # (B,NC,H,CL,CL)
    y_diag = torch.matmul(cb * ll * dt_h[..., None, :], xh)  # (B,NC,H,CL,P)

    # chunk states
    decay_states = torch.exp(cum[..., -1:] - cum)  # (B,NC,H,CL)
    xw = xh * (decay_states * dt_h)[..., None]     # (B,NC,H,CL,P)
    states = torch.matmul(xw.transpose(-1, -2),
                          _repeat_heads(bs, rep, 2))  # (B,NC,H,P,N)

    # inter-chunk recurrence: S_z = exp(sum da_z) * S_{z-1} + states_z
    chunk_decay = torch.exp(cum[..., -1])          # (B,NC,H)
    s_prev = (initial_state if initial_state is not None
              else torch.zeros((bsz, h, p, n), dtype=x.dtype,
                               device=x.device))
    prev = []
    for z in range(nc):
        prev.append(s_prev)
        s_prev = s_prev * chunk_decay[:, z, :, None, None] + states[:, z]
    prev_states = torch.stack(prev, dim=1)         # (B,NC,H,P,N)

    # inter-chunk output
    state_decay = torch.exp(cum)                   # (B,NC,H,CL)
    y_off = torch.matmul(_repeat_heads(cs, rep, 2),
                         prev_states.transpose(-1, -2))      # (B,NC,H,CL,P)
    y_off = y_off * state_decay[..., None]

    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(bsz, l, h, p)
    return y, s_prev


def ssd_decode_step(x, dt, a, b, c, state):
    """One-token recurrent update. x (B,1,H,P); b,c (B,1,G,N); state
    (B,H,P,N). Returns (y (B,1,H,P), new state)."""
    h = x.shape[2]
    rep = h // b.shape[2]
    bt = _repeat_heads(b[:, 0], rep, 1)     # (B,H,N)
    ct = _repeat_heads(c[:, 0], rep, 1)
    dtt = dt[:, 0]                                  # (B,H)
    da = torch.exp(dtt * a[None, :])                # (B,H)
    upd = (dtt[..., None] * x[:, 0])[..., None] * bt[:, :, None, :]
    state = state * da[..., None, None] + upd
    y = torch.matmul(state, ct[..., None])[..., 0]  # (B,H,P)
    return y[:, None], state


def apply_ssm(params, x, cfg: ModelConfig,
              cache: Optional[SSMCache] = None
              ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """Mamba-2 block. x (B,S,D) -> (B,S,D). With a cache: a prompt of S > 1
    runs the chunked scan from the cached state, one token the recurrent
    step; the cache is written in place. Where the step splits the heads
    (``ssm_splits``) the output is this rank's partial sum (module
    docstring); ``params`` then come from ``gathered_ssm``."""
    c: SSMConfig = cfg.ssm
    bsz, s, d = x.shape
    d_in = c.expand * d
    h = d_in // c.head_dim
    g, n = 1, c.state_dim
    split = ssm_splits(cfg)
    w_in, conv_w = params["w_in"], params["conv_w"]
    if split:
        # this rank's heads [idx hl, (idx + 1) hl), channels [lo, lo + cl)
        m, idx = fsdp.split_rank()
        hl = h // m
        cl = hl * c.head_dim
        lo = idx * cl
        cols = ((lo, cl), (d_in + lo, cl), (2 * d_in, 2 * g * n),
                (2 * d_in + 2 * g * n + idx * hl, hl))
        w_in = torch.cat([w_in[:, a:a + k] for a, k in cols], dim=1)
        conv_w = torch.cat([conv_w[:, lo:lo + cl], conv_w[:, d_in:]], dim=1)
    else:
        hl, cl = h, d_in

    zxbcdt = torch.matmul(x, w_in.to(x.dtype))
    z, xb, bc, dt_raw = torch.split(
        zxbcdt, [cl, cl, 2 * g * n, hl], dim=-1)
    # conv over [x, B, C] jointly (mamba2 convention)
    conv_in = torch.cat([xb, bc], dim=-1)           # (B,S,cl+2gn)
    # under a mesh a cache leaf is this rank's block: its split states are
    # gathered here and each rank writes back its block (parallel.kvcache)
    window = None if cache is None else kvcache.read(cache.conv)
    if split and window is not None:
        window = torch.cat([window[..., lo:lo + cl], window[..., d_in:]],
                           dim=-1)
    conv_out, new_conv = causal_conv1d(conv_in, conv_w, window)
    conv_out = F.silu(conv_out)
    xc = conv_out[..., :cl]
    b_mat = conv_out[..., cl:cl + g * n].reshape(bsz, s, g, n).float()
    c_mat = conv_out[..., cl + g * n:].reshape(bsz, s, g, n).float()

    a = -torch.exp(params["a_log"].float())
    dt = softplus(dt_raw.float() + params["dt_bias"].float())
    xh = xc.reshape(bsz, s, hl, c.head_dim)

    if cache is None:
        y, _ = ssd_chunked(xh.float(), dt, a, b_mat, c_mat, min(c.chunk, s))
        new_cache = None
    else:
        state = (kvcache.read_part(cache.state, 1) if split
                 else kvcache.read(cache.state))
        if s > 1:
            # prefill-into-cache: chunked SSD carrying the recurrent state
            y, new_state = ssd_chunked(xh.float(), dt, a, b_mat, c_mat,
                                       min(c.chunk, s),
                                       initial_state=state)
        else:
            y, new_state = ssd_decode_step(xh.float(), dt, a, b_mat, c_mat,
                                           state)
        if split:
            kvcache.write_part(cache.state, new_state, 1)
            # every rank's x channels of the new window, then B and C
            new_conv = torch.cat([fsdp.split_gather(new_conv[..., :cl], -1),
                                  new_conv[..., cl:]], dim=-1)
        else:
            kvcache.write_block(cache.state, new_state)
        kvcache.write_block(cache.conv, new_conv)
        new_cache = cache

    y = y + params["d_skip"].float()[None, None, :, None] * xh.float()
    y = y.reshape(bsz, s, cl).to(x.dtype)
    y = y * F.silu(z)
    y = (split_rmsnorm(y, params["norm"], d_in) if split
         else rmsnorm(y, params["norm"]))
    out = torch.matmul(y, params["w_out"].to(x.dtype))
    return out, new_cache
