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
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, SSMConfig
from repro_torch.models.layers import causal_conv1d, rmsnorm


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
    step; the cache is written in place."""
    c: SSMConfig = cfg.ssm
    bsz, s, d = x.shape
    d_in = c.expand * d
    h = d_in // c.head_dim
    g, n = 1, c.state_dim

    zxbcdt = torch.matmul(x, params["w_in"].to(x.dtype))
    z, xb, bc, dt_raw = torch.split(
        zxbcdt, [d_in, d_in, 2 * g * n, h], dim=-1)
    # conv over [x, B, C] jointly (mamba2 convention)
    conv_in = torch.cat([xb, bc], dim=-1)           # (B,S,d_in+2gn)
    conv_out, new_conv = causal_conv1d(
        conv_in, params["conv_w"], cache.conv if cache is not None else None)
    conv_out = F.silu(conv_out)
    xc = conv_out[..., :d_in]
    b_mat = conv_out[..., d_in:d_in + g * n].reshape(bsz, s, g, n).float()
    c_mat = conv_out[..., d_in + g * n:].reshape(bsz, s, g, n).float()

    a = -torch.exp(params["a_log"].float())
    dt = softplus(dt_raw.float() + params["dt_bias"].float())
    xh = xc.reshape(bsz, s, h, c.head_dim)

    if cache is None:
        y, _ = ssd_chunked(xh.float(), dt, a, b_mat, c_mat, min(c.chunk, s))
        new_cache = None
    else:
        if s > 1:
            # prefill-into-cache: chunked SSD carrying the recurrent state
            y, new_state = ssd_chunked(xh.float(), dt, a, b_mat, c_mat,
                                       min(c.chunk, s),
                                       initial_state=cache.state)
        else:
            y, new_state = ssd_decode_step(xh.float(), dt, a, b_mat, c_mat,
                                           cache.state)
        cache.state.copy_(new_state)
        cache.conv.copy_(new_conv)
        new_cache = cache

    y = y + params["d_skip"].float()[None, None, :, None] * xh.float()
    y = y.reshape(bsz, s, d_in).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm(y, params["norm"])
    out = torch.matmul(y, params["w_out"].to(x.dtype))
    return out, new_cache
