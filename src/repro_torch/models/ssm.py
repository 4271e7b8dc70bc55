"""State-space blocks: Mamba-1 (falcon-mamba) and Mamba-2 / SSD (zamba2)
(port of ``repro.models.ssm``).

The reference computes these in plain jnp, with no Pallas kernel: a
chunked scan, ``lax.scan`` over sequence chunks carrying the recurrent
state, with an associative scan (Mamba-1) or the SSD quadratic-in-chunk
form (Mamba-2) inside each chunk. Here the chunks are a Python loop and,
since torch has no associative scan, :func:`selective_scan` runs a
log-step (Hillis–Steele) doubling along the chunk's time axis:
⌈log₂ chunk⌉ elementwise steps, each combining every position with the
one ``2^j`` before it, not a launch per time step. Its backward is written
out (the adjoint recurrence by the same doubling, reversed in time), so
autograd saves a chunk's inputs and none of its (T, B, d_inner, N)
intermediates; time leads there, so the doubling's slices are contiguous.
The SSD runs head-major, each product a batched matmul. The sums are the reference's in another order, so the
scan agrees to float32 rounding, not bit for bit.

Every projection goes through :func:`~repro_torch.models.layers.alinear`,
so NeuroAda's bypass runs through the fused linear kernel and its value
gradient kernel on the card. Params are the reference's: weights
``(..., d_in, d_out)`` with the layer stack leading (``(L, ...)`` for
Mamba-1, ``(g, per, ...)`` for zamba2's Mamba-2 stacks), ``A_log`` and
``skip_D`` in float32.

Both blocks have a full-sequence form (training, prefill; with
``return_state`` the final conv window and SSM state) and an O(1)
single-token decode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Filler, alinear, rms_norm, softplus

# ----------------------------------------------------------- causal conv1d


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, S, C), w (W, C), b (C,) -> (B, S, C),
    the taps summed in float32 in the reference's order."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):  # width is tiny (4): unrolled taps
        out = out + xp[:, i:i + s].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def conv_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Single-token conv: x_t (B, C), conv_state (B, W-1, C) the past
    inputs -> (y (B, C), the new state (B, W-1, C))."""
    window = torch.cat([conv_state, x_t[:, None]], dim=1)  # (B, W, C)
    y = (window.float() * w.float()).sum(dim=1)
    return (y + b.float()).to(x_t.dtype), window[:, 1:]


# ------------------------------------------------------------- mamba1 core


def _scan_(decay: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The states ``h_t = decay_t h_{t-1} + u_t`` from a zero start along
    axis 0, time (an inclusive scan of the affine maps), by log-step
    doubling (Hillis–Steele): step j folds in the partial result 2^j
    positions back, ping-ponging between two buffers a tensor. Time leads,
    so every slice is contiguous and the elementwise kernels vectorize.
    Overwrites ``decay`` and ``u`` (no autograd: :class:`_ChunkScan`
    carries the gradient)."""
    t, d = u.shape[0], 1
    ubuf, dbuf = torch.empty_like(u), torch.empty_like(decay)
    while d < t:
        torch.addcmul(u[d:], decay[d:], u[:-d], out=ubuf[d:])
        ubuf[:d] = u[:d]
        u, ubuf = ubuf, u
        if 2 * d < t:  # the decays' products, but for the last step
            torch.mul(decay[d:], decay[:-d], out=dbuf[d:])
            dbuf[:d] = decay[:d]
            decay, dbuf = dbuf, decay
        d *= 2
    return u


def _chunk_states(dt, dtx, a, b, h0) -> torch.Tensor:
    """A chunk's states (T, B, di, N): decays ``exp(dt A)``, inputs ``dt x
    B``, the carried state folded into the first step's input."""
    decay = torch.exp(dt[..., None] * a)
    u = dtx[..., None] * b[:, :, None, :]
    u[0].addcmul_(decay[0], h0)
    return _scan_(decay, u)


class _ChunkScan(torch.autograd.Function):
    """One chunk of the Mamba-1 scan, time-major float32: (dt, dt·x (T, B,
    di), A (di, N), B, C (T, B, N), the carried state (B, di, N)) -> (y (T,
    B, di), the last state). Only the inputs are saved; the backward
    recomputes the states and runs the adjoint recurrence ``λ_t = C_t dy_t
    + decay_{t+1} λ_{t+1}`` by the same doubling on the time-reversed
    chunk, so a layer never keeps the scan's (T, B, di, N) intermediates for
    autograd."""

    @staticmethod
    def forward(ctx, dt, dtx, a, b, c, h0):
        states = _chunk_states(dt, dtx, a, b, h0)
        ctx.save_for_backward(dt, dtx, a, b, c, h0)
        return torch.einsum("tbdn,tbn->tbd", states, c), states[-1].clone()

    @staticmethod
    def backward(ctx, gy, gh):
        dt, dtx, a, b, c, h0 = ctx.saved_tensors
        states = _chunk_states(dt, dtx, a, b, h0)
        decay = torch.exp(dt[..., None] * a)
        g = (gy[..., None] * c[:, :, None, :]).flip(0)  # time-reversed from here
        g[0] += gh
        rdecay = torch.empty_like(decay)
        rdecay[0] = 1.0  # multiplies the zero start: any value
        rdecay[1:] = decay[1:].flip(0)
        lam = _scan_(rdecay, g).flip(0)  # dL/dh_t through every later step
        gc = torch.einsum("tbdn,tbd->tbn", states, gy)
        prev = torch.cat([h0[None], states[:-1]])
        del states
        gz = lam * prev * decay  # d/d(dt A): exp's derivative is itself
        del prev
        gh0 = lam[0] * decay[0]
        del decay
        return (torch.einsum("tbdn,dn->tbd", gz, a), torch.einsum("tbdn,tbn->tbd", lam, b),
                torch.einsum("tbdn,tbd->dn", gz, dt), torch.einsum("tbdn,tbd->tbn", lam, dtx),
                gc, gh0)


def selective_scan(x, dt, a_mat, b_in, c_in, chunk: int):
    """Mamba-1 recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``,
    ``y_t = C_t · h_t``: x, dt (B, S, di); a_mat (di, N); b_in, c_in (B, S,
    N). Returns (y (B, S, di) in x's dtype, the final state (B, di, N)
    float32). Chunks of ``min(chunk, S)`` steps (the reference pads the last
    with dt = 0, a decay of 1; here it is shorter: the same states); only one
    chunk's (chunk, B, di, N) decays and states are live at a time, and
    autograd keeps none of them (:class:`_ChunkScan`)."""
    bsz, s, di = x.shape
    chunk = min(chunk, s)
    # time-major (S, B, ...): a chunk is a contiguous slice
    dtf = dt.float().transpose(0, 1).contiguous()
    dtx = dtf * x.float().transpose(0, 1)
    bf, cf = (t.float().transpose(0, 1).contiguous() for t in (b_in, c_in))
    h = torch.zeros((bsz, di, a_mat.shape[-1]), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)  # a short last chunk is the reference's padded one
        y, h = _ChunkScan.apply(dtf[sl], dtx[sl], a_mat.float(), bf[sl], cf[sl], h)
        ys.append(y)
    return torch.cat(ys).transpose(0, 1).to(x.dtype), h


def init_mamba1_block(cfg, fill: Filler, dt) -> dict:
    """The (L, ...) Mamba-1 stack with the reference's distributions."""
    D, di = cfg.d_model, cfg.resolved_d_inner
    n, dtr, cw, L = cfg.ssm_state, cfg.resolved_dt_rank, cfg.conv_width, cfg.num_layers
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=fill.device))
    return {
        "norm": fill.ones((L, D), dt),
        "in_proj": fill.linear(D, 2 * di, dt, stack=(L,)),
        "conv_w": fill.normal((L, cw, di), 0.2, dt),
        "conv_b": fill.zeros((L, di), dt),
        "x_proj": fill.linear(di, dtr + 2 * n, dt, stack=(L,)),
        "dt_proj": fill.linear(dtr, di, dt, bias=True, stack=(L,)),
        "A_log": a_log.expand(L, di, n).contiguous(),
        "skip_D": fill.ones((L, di), torch.float32),
        "out_proj": fill.linear(di, D, dt, stack=(L,)),
    }


def mamba1_block(cfg, p, a, h, *, return_state: bool = False):
    """Full-sequence Mamba-1 block with its residual: h (B, S, D). With
    ``return_state`` also (the last W-1 pre-conv inputs (B, W-1, di), the
    final SSM state (B, di, N))."""
    n, dtr, cw = cfg.ssm_state, cfg.resolved_dt_rank, cfg.conv_width
    x = rms_norm(h, p["norm"], cfg.norm_eps)
    xc_raw, z = alinear(p, a, "in_proj", x).chunk(2, dim=-1)
    xc = F.silu(causal_conv(xc_raw, p["conv_w"], p["conv_b"]))
    proj = alinear(p, a, "x_proj", xc)
    dt_r, b_in, c_in = proj[..., :dtr], proj[..., dtr:dtr + n], proj[..., dtr + n:]
    dt = softplus(alinear(p, a, "dt_proj", dt_r).float())
    y, h_last = selective_scan(xc, dt, -torch.exp(p["A_log"]), b_in, c_in, cfg.ssm_chunk)
    y = (y + xc * p["skip_D"].to(xc.dtype)) * F.silu(z)
    out = h + alinear(p, a, "out_proj", y)
    if return_state:  # a copy: a view would keep the whole projection alive
        return out, (xc_raw[:, -(cw - 1):].contiguous(), h_last)
    return out


def mamba1_decode(cfg, p, a, h, conv_state, ssm_state):
    """Single token: h (B, 1, D), conv_state (B, W-1, di), ssm_state (B, di,
    N) float32 -> (h, conv_state, ssm_state)."""
    n, dtr = cfg.ssm_state, cfg.resolved_dt_rank
    x = rms_norm(h, p["norm"], cfg.norm_eps)
    xc, z = alinear(p, a, "in_proj", x)[:, 0].chunk(2, dim=-1)
    xc, conv_state = conv_step(xc, conv_state, p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    proj = alinear(p, a, "x_proj", xc)
    dt_r, b_in, c_in = proj[..., :dtr], proj[..., dtr:dtr + n], proj[..., dtr + n:]
    dt = softplus(alinear(p, a, "dt_proj", dt_r).float())  # (B, di)
    decay = torch.exp(dt[..., None] * -torch.exp(p["A_log"]))  # (B, di, N)
    ssm_state = decay * ssm_state + (dt * xc.float())[..., None] * b_in.float()[:, None, :]
    y = torch.einsum("bdn,bn->bd", ssm_state, c_in.float())
    y = (y + xc.float() * p["skip_D"]).to(h.dtype) * F.silu(z)
    return h + alinear(p, a, "out_proj", y[:, None]), conv_state, ssm_state


# --------------------------------------------------------- mamba2 (SSD) core


def ssd_scan(x, dt, a_head, b_in, c_in, chunk: int):
    """Mamba-2 SSD, a scalar decay per head, in the chunked matmul form:
    x (B, S, H, P); dt (B, S, H); a_head (H,) negative; b_in, c_in (B, S,
    N). Returns (y (B, S, H, P) in x's dtype, the final state (B, H, P, N)
    float32).

    Inside a chunk, ``y_t = Σ_{s<=t} (C_t·B_s) exp(cum_t - cum_s) dt_s x_s``
    plus the carried state's term. The reference forms ``exp(cum_t -
    cum_s)`` for every (t, s) and then zeroes t < s with a triangle, which
    overflows to inf (and inf × 0 = NaN) once a chunk's decays sum past
    ≈ 88; here the exponent is masked to -inf first, so those entries are 0
    and every entry the reference keeps is its own."""
    bsz, s, hh, pp = x.shape
    chunk = min(chunk, s)
    dtf = dt.float()
    # head-major (B, H, S[, P]): every product below is a batched matmul
    # over (B, H) with no permuted copy of a (T, T) tensor
    cum_all = (dtf * a_head.float()).transpose(1, 2)  # (B, H, S) log-decay
    dtx = (dtf[..., None] * x.float()).permute(0, 2, 1, 3)  # (B, H, S, P)
    bf, cf = b_in.float(), c_in.float()
    h = torch.zeros((bsz, hh, pp, b_in.shape[-1]), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)  # a short last chunk is the reference's padded one
        dx, bb, cc = dtx[:, :, sl], bf[:, sl], cf[:, sl]
        t = bb.shape[1]
        cum = torch.cumsum(cum_all[:, :, sl], dim=-1)  # (B, H, T)
        scores = (cc @ bb.transpose(1, 2))[:, None]  # (B, 1, T, T): C_t · B_s
        tri = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        decay = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(~tri,
                                                                              float("-inf")))
        y = (scores * decay) @ dx  # (B, H, T, P): the chunk's own inputs
        ecum = torch.exp(cum)
        y = y + ecum[..., None] * (cc[:, None] @ h.transpose(-1, -2))  # the carried state
        tail = torch.exp(cum[..., -1:] - cum)  # decay from s to the chunk's end
        h = ecum[..., -1, None, None] * h + (dx * tail[..., None]).transpose(-1, -2) @ bb[:, None]
        ys.append(y)
    return torch.cat(ys, dim=2).permute(0, 2, 1, 3).to(x.dtype), h


def init_mamba2_block(cfg, fill: Filler, dt, stack: tuple) -> dict:
    """A Mamba-2 stack of leading shape ``stack`` with the reference's
    distributions."""
    D, di = cfg.d_model, cfg.resolved_d_inner
    n, cw, hh = cfg.ssm_state, cfg.conv_width, cfg.ssm_heads
    return {
        "norm": fill.ones((*stack, D), dt),
        "in_proj": fill.linear(D, 2 * di, dt, stack=stack),
        "conv_w": fill.normal((*stack, cw, di), 0.2, dt),
        "conv_b": fill.zeros((*stack, di), dt),
        "bc_proj": fill.linear(di, 2 * n, dt, stack=stack),
        "dt_proj": fill.linear(D, hh, dt, bias=True, stack=stack),
        "A_log": fill.zeros((*stack, hh), torch.float32),  # A = -exp(0) = -1 at init
        "skip_D": fill.ones((*stack, hh), torch.float32),
        "gate_norm": fill.ones((*stack, di), dt),
        "out_proj": fill.linear(di, D, dt, stack=stack),
    }


def mamba2_block(cfg, p, a, h, *, return_state: bool = False):
    """Full-sequence Mamba-2 block with its residual: h (B, S, D). With
    ``return_state`` also (the last W-1 pre-conv inputs, the final SSM state
    (B, H, P, N))."""
    di, hh, pp, cw = cfg.resolved_d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.conv_width
    bsz, s, _ = h.shape
    x = rms_norm(h, p["norm"], cfg.norm_eps)
    xc_raw, z = alinear(p, a, "in_proj", x).chunk(2, dim=-1)
    xc = F.silu(causal_conv(xc_raw, p["conv_w"], p["conv_b"]))
    b_in, c_in = alinear(p, a, "bc_proj", xc).chunk(2, dim=-1)
    dt = softplus(alinear(p, a, "dt_proj", x).float())  # (B, S, H)
    xh = xc.reshape(bsz, s, hh, pp)
    y, h_last = ssd_scan(xh, dt, -torch.exp(p["A_log"]), b_in, c_in, cfg.ssm_chunk)
    y = (y + xh * p["skip_D"].to(xh.dtype)[None, None, :, None]).reshape(bsz, s, di)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = h + alinear(p, a, "out_proj", y)
    if return_state:  # a copy: a view would keep the whole projection alive
        return out, (xc_raw[:, -(cw - 1):].contiguous(), h_last)
    return out


def mamba2_decode(cfg, p, a, h, conv_state, ssm_state):
    """Single token: h (B, 1, D), conv_state (B, W-1, di), ssm_state (B, H,
    P, N) float32 -> (h, conv_state, ssm_state)."""
    di, hh, pp = cfg.resolved_d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    x = rms_norm(h, p["norm"], cfg.norm_eps)
    xc, z = alinear(p, a, "in_proj", x)[:, 0].chunk(2, dim=-1)
    xc, conv_state = conv_step(xc, conv_state, p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    b_in, c_in = alinear(p, a, "bc_proj", xc).chunk(2, dim=-1)  # (B, N)
    dt = softplus(alinear(p, a, "dt_proj", x[:, 0]).float())  # (B, H)
    decay = torch.exp(dt * -torch.exp(p["A_log"]))  # (B, H)
    xh = xc.reshape(-1, hh, pp).float()
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, xh, b_in.float())
    ssm_state = decay[..., None, None] * ssm_state + upd
    y = torch.einsum("bhpn,bn->bhp", ssm_state, c_in.float()) + xh * p["skip_D"][None, :, None]
    y = rms_norm(y.reshape(-1, di).to(h.dtype) * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return h + alinear(p, a, "out_proj", y[:, None]), conv_state, ssm_state
