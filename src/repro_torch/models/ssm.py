"""State-space / recurrent blocks (port of ``repro.models.ssm``): mLSTM
and sLSTM (xLSTM) and Mamba2 (SSD), function for function.

Each block family exposes:
  init_*          — parameter dict (the reference pytree's layout)
  *_seq           — full-sequence form (scoring)
  *_init_state    — recurrent state for decode
  *_step          — one-token decode step

mLSTM's full-sequence form is the stabilized quadratic (gated
attention) form; Mamba2's is the chunked SSD (quadratic within a chunk,
a scan across chunks); sLSTM is sequential (recurrent gate connections)
and runs as a loop over time. The casts to float32 sit where the
reference puts them: gates, the mLSTM's ``c`` / ``n`` / ``m`` and the
SSM state are f32, the conv state and every projection are in the model
dtype; the Mamba2 leaves ``a_log``, ``dt_bias`` and ``d_skip`` are f32
whatever the model dtype. The reference's ``slstm_seq`` runs its scan
inside ``shard_map`` under a production mesh, which no serving path
reaches; the port has the local form only.

No TPU kernel sits on these paths, so they are PyTorch ops throughout.
The f32 log-sigmoid differs from XLA's in the last bits on about 1.6 %
of inputs, so the f32 gates and states match the reference within a
stated tolerance, not bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

NEG_INF = -1e30

State = Dict[str, torch.Tensor]


def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``-softplus(-x)`` (f32)."""
    return F.logsigmoid(x)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(−|x|)), with no linear cut-off (``F.softplus`` returns x
    past 20)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


# ===========================================================================
# mLSTM (xLSTM's matrix-memory cell)
# ===========================================================================


def init_mlstm(gen: Optional[torch.Generator], device, d_model: int,
               num_heads: int, dtype=torch.float32) -> Dict[str, object]:
    """mLSTM block: up-proj (2x), causal conv4, qkv, gates, down-proj."""
    d_in = 2 * d_model
    head_dim = d_in // num_heads
    std = d_model ** -0.5
    s_in = d_in ** -0.5
    tn = lambda shape, s: L.trunc_normal(shape, s, gen, device, dtype)
    return {
        "w_up": tn((d_model, 2 * d_in), std),
        "conv": tn((4, d_in), 0.3),
        "wq": tn((d_in, num_heads, head_dim), s_in),
        "wk": tn((d_in, num_heads, head_dim), s_in),
        "wv": tn((d_in, num_heads, head_dim), s_in),
        "w_if": tn((d_in, 2 * num_heads), s_in),
        "b_if": torch.cat([
            torch.zeros((num_heads,), dtype=dtype, device=device),
            torch.full((num_heads,), 3.0, dtype=dtype, device=device),
        ]),                                       # forget-gate bias high
        "out_norm": L.init_norm("rmsnorm", d_in, dtype, device),
        "w_down": tn((d_in, d_model), s_in),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, width W. x ``[B, n, C]``, w ``[W, C]``.
    Op by op in x's dtype, each product and each partial sum rounded, as
    the reference's ``sum`` of products is."""
    width, n = w.shape[0], x.shape[-2]
    if state is None:
        pad = torch.zeros(x.shape[:-2] + (width - 1, x.shape[-1]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=-2)
    out = xp[..., 0:n, :] * w[0]
    for i in range(1, width):
        out = out + xp[..., i:i + n, :] * w[i]
    return out, xp[..., -(width - 1):, :]


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bne,ehk->bhnk")``: x ``[B, n, e]`` → ``[B, H, n, k]``."""
    e, h, k = w.shape
    return (x @ w.reshape(e, h * k)).reshape(*x.shape[:-1], h, k
                                             ).transpose(-3, -2)


def mlstm_seq(params, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Parallel mLSTM over a full sequence. x ``[B, n, d_model]``."""
    batch, n, _ = x.shape
    up = x @ params["w_up"]
    z, h_in = up.chunk(2, dim=-1)
    h_in, _ = _causal_conv(h_in, params["conv"])
    h_in = L.silu(h_in)

    q = _heads(h_in, params["wq"])
    k = _heads(h_in, params["wk"])
    v = _heads(h_in, params["wv"])
    head_dim = q.shape[-1]

    gates = h_in @ params["w_if"] + params["b_if"]
    i_pre, f_pre = gates.chunk(2, dim=-1)                 # [B, n, H]
    log_i = i_pre.float().transpose(1, 2)                 # [B, H, n]
    log_f = _logsigmoid(f_pre.float()).transpose(1, 2)

    # stabilized gated score matrix D (xLSTM eq. 25-27)
    f_cum = torch.cumsum(log_f, dim=-1)
    log_d = f_cum[..., :, None] - f_cum[..., None, :] + log_i[..., None, :]
    causal = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
    log_d = torch.where(causal, log_d, NEG_INF)
    m = log_d.amax(dim=-1, keepdim=True)                  # row stabilizer
    d_mat = torch.exp(log_d - m)

    s = (q.float() @ k.float().transpose(-1, -2)) * (head_dim ** -0.5)
    w_mat = s * d_mat
    norm = torch.maximum(w_mat.sum(dim=-1, keepdim=True).abs(),
                         torch.exp(-m))
    h = (w_mat / norm) @ v.float()

    h = h.transpose(1, 2).reshape(batch, n, -1).to(x.dtype)
    h = L.rmsnorm(params["out_norm"], h)
    h = h * L.silu(z)
    return h @ params["w_down"]


def mlstm_init_state(batch: int, d_model: int, num_heads: int, dtype,
                     device=None) -> State:
    d_in = 2 * d_model
    head_dim = d_in // num_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((batch, num_heads, head_dim, head_dim), **f32),
        "n": torch.zeros((batch, num_heads, head_dim), **f32),
        "m": torch.zeros((batch, num_heads), **f32),
        "conv": torch.zeros((batch, 3, d_in), dtype=dtype, device=device),
    }


def mlstm_step(params, x: torch.Tensor, state: State, num_heads: int
               ) -> Tuple[torch.Tensor, State]:
    """One decode step. x ``[B, 1, d_model]`` → (y, new_state)."""
    up = x @ params["w_up"]
    z, h_in = up.chunk(2, dim=-1)
    h_in, conv_state = _causal_conv(h_in, params["conv"], state["conv"])
    h_in = L.silu(h_in)
    h0 = h_in[:, 0]

    def proj(w):
        e, h, k = w.shape
        return (h0 @ w.reshape(e, h * k)).reshape(-1, h, k)

    q, k, v = proj(params["wq"]), proj(params["wk"]), proj(params["wv"])
    head_dim = q.shape[-1]
    gates = h0 @ params["w_if"] + params["b_if"]
    i_pre, f_pre = gates.float().chunk(2, dim=-1)         # [B, H]
    log_i = i_pre
    log_f = _logsigmoid(f_pre)

    m_new = torch.maximum(log_f + state["m"], log_i)
    i_g = torch.exp(log_i - m_new)[..., None]
    f_g = torch.exp(log_f + state["m"] - m_new)[..., None]

    kf = k.float() * (head_dim ** -0.5)
    c_new = f_g[..., None] * state["c"] + i_g[..., None] * (
        kf[..., :, None] * v.float()[..., None, :])
    n_new = f_g * state["n"] + i_g * kf
    qf = q.float()
    num = (qf[..., None, :] @ c_new)[..., 0, :]           # [B, H, hd]
    den = torch.maximum((qf * n_new).sum(dim=-1).abs(),
                        torch.exp(-m_new))[..., None]
    h = (num / den).reshape(x.shape[0], 1, -1).to(x.dtype)
    h = L.rmsnorm(params["out_norm"], h)
    h = h * L.silu(z)
    y = h @ params["w_down"]
    return y, {"c": c_new, "n": n_new, "m": m_new, "conv": conv_state}


# ===========================================================================
# sLSTM (xLSTM's scalar cell with recurrent gate connections)
# ===========================================================================


def init_slstm(gen: Optional[torch.Generator], device, d_model: int,
               num_heads: int, dtype=torch.float32) -> Dict[str, object]:
    head_dim = d_model // num_heads
    std = d_model ** -0.5
    tn = lambda shape, s: L.trunc_normal(shape, s, gen, device, dtype)
    return {
        # input weights for 4 gates (i, f, z, o)
        "w_x": tn((d_model, 4 * d_model), std),
        # block-diagonal recurrent weights, one [hd, hd] per head per gate
        "r_h": tn((4, num_heads, head_dim, head_dim), head_dim ** -0.5),
        "bias": torch.cat([
            torch.zeros((d_model,), dtype=dtype, device=device),
            torch.full((d_model,), 3.0, dtype=dtype, device=device),
            torch.zeros((2 * d_model,), dtype=dtype, device=device),
        ]),
        "out_norm": L.init_norm("rmsnorm", d_model, dtype, device),
        "w_out": tn((d_model, d_model), std),
    }


def _slstm_cell(params, xt: torch.Tensor, state: State, num_heads: int
                ) -> State:
    """xt ``[B, d]``; state dict of ``[B, d]`` f32 (+ stabilizer m)."""
    batch, d = xt.shape
    hd = d // num_heads
    h_prev = state["h"].reshape(batch, num_heads, 1, hd)
    # einsum("bhk,ghkl->bghl"): per gate and head, h_prev @ r_h
    rec = (h_prev[:, None] @ params["r_h"].float()[None])  # [B,4,H,1,hd]
    rec = rec.reshape(batch, 4 * d)
    pre = (xt.float() @ params["w_x"].float() + rec
           + params["bias"].float())
    i_pre, f_pre, z_pre, o_pre = pre.chunk(4, dim=-1)
    log_i = i_pre
    log_f = _logsigmoid(f_pre)
    m_new = torch.maximum(log_f + state["m"], log_i)
    i_g = torch.exp(log_i - m_new)
    f_g = torch.exp(log_f + state["m"] - m_new)
    c_new = f_g * state["c"] + i_g * torch.tanh(z_pre)
    n_new = f_g * state["n"] + i_g
    h_new = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1e-6)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def slstm_init_state(batch: int, d_model: int, dtype=torch.float32,
                     device=None) -> State:
    return {k: torch.zeros((batch, d_model), dtype=torch.float32,
                           device=device) for k in ("c", "n", "h", "m")}


def slstm_seq(params, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Sequential sLSTM over the sequence, step by step in order.
    x ``[B, n, d]``."""
    batch, n, d = x.shape
    state = slstm_init_state(batch, d, device=x.device)
    hs = []
    for t in range(n):
        state = _slstm_cell(params, x[:, t], state, num_heads)
        hs.append(state["h"])
    h = torch.stack(hs, dim=1).to(x.dtype)
    h = L.rmsnorm(params["out_norm"], h)
    return h @ params["w_out"]


def slstm_step(params, x: torch.Tensor, state: State, num_heads: int
               ) -> Tuple[torch.Tensor, State]:
    """x ``[B, 1, d]`` → (y ``[B, 1, d]``, new_state)."""
    new = _slstm_cell(params, x[:, 0], state, num_heads)
    h = L.rmsnorm(params["out_norm"], new["h"][:, None].to(x.dtype))
    return h @ params["w_out"], new


# ===========================================================================
# Mamba2 (SSD — state-space duality), used by zamba2
# ===========================================================================


def init_mamba2(gen: Optional[torch.Generator], device, d_model: int,
                d_state: int, head_dim: int = 64, expand: int = 2,
                dtype=torch.float32) -> Dict[str, object]:
    d_in = expand * d_model
    num_heads = d_in // head_dim
    conv_dim = d_in + 2 * d_state
    std = d_model ** -0.5
    f32 = dict(dtype=torch.float32, device=device)
    tn = lambda shape, s: L.trunc_normal(shape, s, gen, device, dtype)
    return {
        # fused in-proj: [z, x, B, C, dt]
        "w_in": tn((d_model, 2 * d_in + 2 * d_state + num_heads), std),
        "conv": tn((4, conv_dim), 0.3),
        "a_log": torch.log(torch.linspace(1.0, 16.0, num_heads, **f32)),
        "dt_bias": torch.zeros((num_heads,), **f32),
        "d_skip": torch.ones((num_heads,), **f32),
        "out_norm": L.init_norm("rmsnorm", d_in, dtype, device),
        "w_out": tn((d_in, d_model), d_in ** -0.5),
    }


def _mamba2_proj(params, x: torch.Tensor, d_state: int, head_dim: int,
                 expand: int, conv_state: Optional[torch.Tensor] = None):
    d_model = x.shape[-1]
    d_in = expand * d_model
    num_heads = d_in // head_dim
    proj = x @ params["w_in"]
    z = proj[..., :d_in]
    xbc = proj[..., d_in:d_in + d_in + 2 * d_state]
    dt_pre = proj[..., -num_heads:]
    xbc, new_conv = _causal_conv(xbc, params["conv"], conv_state)
    xbc = L.silu(xbc)
    xs = xbc[..., :d_in]
    b = xbc[..., d_in:d_in + d_state]
    c = xbc[..., d_in + d_state:]
    dt = _softplus(dt_pre.float() + params["dt_bias"])        # [B, n, H]
    return z, xs, b, c, dt, new_conv


def mamba2_seq(params, x: torch.Tensor, d_state: int, head_dim: int = 64,
               expand: int = 2, chunk: int = 128) -> torch.Tensor:
    """Chunked SSD over a full sequence. x ``[B, n, d_model]``."""
    batch, n, d_model = x.shape
    d_in = expand * d_model
    num_heads = d_in // head_dim
    chunk = min(chunk, n)
    while n % chunk:
        chunk //= 2
    nc = n // chunk

    z, xs, b, c, dt, _ = _mamba2_proj(params, x, d_state, head_dim, expand)
    xh = xs.reshape(batch, nc, chunk, num_heads, head_dim)
    bt = b.reshape(batch, nc, chunk, d_state).float()
    ct = c.reshape(batch, nc, chunk, d_state).float()
    dtc = dt.reshape(batch, nc, chunk, num_heads)
    a = -torch.exp(params["a_log"])                        # [H], negative
    log_a = dtc * a                                        # [B,nc,L,H]
    ca = torch.cumsum(log_a, dim=2)                        # within-chunk

    xdt = xh.float() * dtc[..., None]                      # [B,nc,L,H,P]

    # --- intra-chunk (quadratic within L) ---
    g = ct @ bt.transpose(-1, -2)                          # [B,nc,t,s]
    decay = ca[..., :, None, :] - ca[..., None, :, :]      # [B,nc,t,s,H]
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    decay = torch.where(tri[None, None, ..., None], decay, NEG_INF)
    w = g[..., None] * torch.exp(decay)                    # [B,nc,t,s,H]
    # einsum("bctsh,bcshp->bcthp")
    y_intra = (w.permute(0, 1, 4, 2, 3) @ xdt.permute(0, 1, 3, 2, 4)
               ).permute(0, 1, 3, 2, 4)

    # --- chunk-boundary states + inter-chunk scan ---
    decay_end = ca[..., -1:, :] - ca                       # [B,nc,L,H]
    # einsum("bcls,bclhp,bclh->bchsp")
    weighted = xdt * torch.exp(decay_end)[..., None]       # [B,nc,L,H,P]
    s_chunk = bt.transpose(-1, -2)[:, :, None] @ weighted.permute(
        0, 1, 3, 2, 4)                                     # [B,nc,H,N,P]
    a_total = torch.exp(ca[..., -1, :])                    # [B,nc,H]

    s_prev = torch.zeros((batch, num_heads, d_state, head_dim),
                         dtype=torch.float32, device=x.device)
    s_in = []
    for ci in range(nc):
        s_in.append(s_prev)
        s_prev = a_total[:, ci, :, None, None] * s_prev + s_chunk[:, ci]
    s_in = torch.stack(s_in, dim=1)                        # [B,nc,H,N,P]

    # einsum("bcts,bchsp,bcth->bcthp")
    y_inter = (ct[:, :, None] @ s_in).permute(0, 1, 3, 2, 4) \
        * torch.exp(ca)[..., None]

    y = y_intra + y_inter + params["d_skip"][..., None] * xh.float()
    y = y.reshape(batch, n, d_in).to(x.dtype)
    y = L.rmsnorm(params["out_norm"], y * L.silu(z))
    return y @ params["w_out"]


def mamba2_init_state(batch: int, d_model: int, d_state: int,
                      head_dim: int = 64, expand: int = 2,
                      dtype=torch.float32, device=None) -> State:
    d_in = expand * d_model
    num_heads = d_in // head_dim
    return {
        "ssm": torch.zeros((batch, num_heads, d_state, head_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, 3, d_in + 2 * d_state), dtype=dtype,
                            device=device),
    }


def mamba2_step(params, x: torch.Tensor, state: State, d_state: int,
                head_dim: int = 64, expand: int = 2
                ) -> Tuple[torch.Tensor, State]:
    """One decode step. x ``[B, 1, d_model]``."""
    batch = x.shape[0]
    z, xs, b, c, dt, conv_state = _mamba2_proj(
        params, x, d_state, head_dim, expand, state["conv"])
    num_heads = xs.shape[-1] // head_dim
    xh = xs[:, 0].reshape(batch, num_heads, head_dim).float()
    bt = b[:, 0].float()                                   # [B, N]
    ct = c[:, 0].float()
    dt1 = dt[:, 0]                                         # [B, H]
    a = -torch.exp(params["a_log"])
    a_step = torch.exp(dt1 * a)                            # [B, H]
    # einsum("bs,bhp,bh->bhsp")
    s_new = (a_step[..., None, None] * state["ssm"]
             + bt[:, None, :, None] * (xh * dt1[..., None])[:, :, None, :])
    y = (ct[:, None, None, :] @ s_new)[:, :, 0]            # [B, H, P]
    y = y + params["d_skip"][..., None] * xh
    y = y.reshape(batch, 1, -1).to(x.dtype)
    y = L.rmsnorm(params["out_norm"], y * L.silu(z))
    return y @ params["w_out"], {"ssm": s_new, "conv": conv_state}
