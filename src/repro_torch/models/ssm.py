"""State-space blocks: Mamba1 (selective scan) and Mamba2 (SSD), + decode.

The reference's chunked formulation (``repro.models.ssm``): the sequence is
cut into chunks of ``cfg.ssm_chunk`` steps, the recurrence is evaluated in
parallel within a chunk, and one state-sized carry crosses each chunk
boundary (a Python loop over the chunks here, the reference's
``lax.scan``).  Within a chunk, Mamba1's diagonal recurrence is a doubling
(Hillis–Steele) scan of log2(Q) passes under the reference's combine
``(l0·r0, l1·r0 + r1)``: torch has no ``associative_scan``, a cumsum of
``log dA`` overflows in ``exp(-cum)`` at falcon's decay rates, and a loop
over steps is 2,048 launches a layer.  Its float32 sums run in another
order than ``jax.lax.associative_scan``'s, so it agrees with the reference
within float32 rounding, not bitwise.  Mamba2's chunk step is the
reference's matmul-form SSD, with the (Qi, Qj) score contracted into the
decay tensor before the product with the inputs, so no (B, Q, Q, H, P)
intermediate exists.

The dtype promotions are the reference's: the projections and the causal
conv run in the model's dtype; ``delta``, ``B``, ``C``, the decays and the
states in float32; ``y`` is cast back to the input's dtype before the
``silu(z)`` gate.  ``A_log``, ``D`` and ``dt_bias`` are float32 in any
model.  Decode is the one-step recurrence; it writes the cache's conv
window and state in place (the port's cache convention, ``model.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import (init_linear, keep_shards, linear, on_shards, settle,
                     torch_dtype, truncated_normal)

__all__ = ["init_mamba1", "mamba1_forward", "mamba1_decode",
           "init_mamba2", "mamba2_forward", "mamba2_decode"]


def _dt_rank(cfg) -> int:
    return max(cfg.d_model // 16, 1)


def _init_conv(gen: torch.Generator, cfg, dt: torch.dtype) -> dict:
    di, W = cfg.d_inner, cfg.ssm_conv
    return {"conv": truncated_normal(gen, (di, W), W ** -0.5, dt),
            "conv_b": torch.zeros((di,), dtype=dt, device=gen.device)}


# ===================================================================== Mamba1
def init_mamba1(gen: torch.Generator, cfg) -> dict:
    d, di, s = cfg.d_model, cfg.d_inner, cfg.ssm_state
    r = _dt_rank(cfg)
    dt = torch_dtype(cfg)
    p = {"in_proj": init_linear(gen, d, 2 * di, dt), **_init_conv(gen, cfg, dt),
         "x_proj": init_linear(gen, di, r + 2 * s, dt),
         "dt_proj": init_linear(gen, r, di, dt, bias=True)}
    a = torch.arange(1, s + 1, dtype=torch.float32, device=gen.device)
    p["A_log"] = torch.log(a).expand(di, s).contiguous()
    p["D"] = torch.ones((di,), dtype=torch.float32, device=gen.device)
    p["out_proj"] = init_linear(gen, di, d, dt, scale=di ** -0.5)
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 window: int) -> torch.Tensor:
    """x: (B, L, di); depthwise causal conv along L, as ``window`` shifted
    multiply-adds in x's dtype (the reference's shift-and-scale form).  Of
    DTensors, on each rank's rows and channels."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if isinstance(x, DTensor):
        at = keep_shards(x, (0, 2))
        w_at = tuple(Shard(0) if p == Shard(2) else Replicate() for p in at)
        w_grad = tuple(Partial() if p == Shard(0) else q for p, q in zip(at, w_at))
        return on_shards(lambda x_, w_, b_: _causal_conv(x_, w_, b_, window),
                         (x, w, b), (at, w_at, w_at), list(at), (at, w_grad, w_grad))
    L = x.shape[1]
    xp = F.pad(x, (0, 0, window - 1, 0))
    out = xp[:, 0:L] * w[:, 0]
    for i in range(1, window):
        out = out + xp[:, i:i + L] * w[:, i]
    return out + b


def _doubling_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along dim 1 of the pairs (a, b) under the combine
    ``(l0·r0, l1·r0 + r1)``: after it, ``b[:, t]`` is the state at step t
    from a zero state and ``a[:, t]`` the product of the decays to t."""
    Q, off = a.shape[1], 1
    while off < Q:
        b = torch.cat((b[:, :off], torch.addcmul(b[:, off:], a[:, off:], b[:, :-off])),
                      dim=1)
        a = torch.cat((a[:, :off], a[:, off:] * a[:, :-off]), dim=1)
        off *= 2
    return a, b


def _shared_operand(at: tuple) -> tuple:
    """The placements of a (B, L, s) operand that every channel or head of
    a scan placed ``at`` reads: its rows where the scan's are, whole over
    the dims that cut the channels; and its gradient's, a partial sum over
    those dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    c_at = tuple(p if p == Shard(0) else Replicate() for p in at)
    c_grad = tuple(Partial() if isinstance(p, Shard) and p.dim != 0 else q
                   for p, q in zip(at, c_at))
    return c_at, c_grad


def _mamba1_ssm_chunked(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
                        chunk: int) -> torch.Tensor:
    """Diagonal linear recurrence h_t = dA_t * h_{t-1} + dBx_t, y_t = <C_t, h_t>.

    dA, dBx: (B, L, di, s); C: (B, L, s).  Returns y: (B, L, di).  Of
    DTensors, on each rank's rows and channels (the scan runs along L)."""
    from torch.distributed.tensor import DTensor
    if isinstance(dA, DTensor):
        at = keep_shards(dA, (0, 2))
        c_at, c_grad = _shared_operand(at)
        return on_shards(lambda a, b, c: _mamba1_ssm_chunked(a, b, c, chunk),
                         (dA, dBx, C), (at, at, c_at), list(at), (at, at, c_grad))
    B, L, di, s = dA.shape
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        dA = F.pad(dA, (0, 0, 0, 0, 0, pad), value=1.0)
        dBx = F.pad(dBx, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    h = dA.new_zeros((B, di, s))
    ys = []
    for q0 in range(0, L + pad, Q):
        aa, hh = _doubling_scan(dA[:, q0:q0 + Q], dBx[:, q0:q0 + Q])
        hq = torch.addcmul(hh, aa, h[:, None])                 # inject the carry
        ys.append(torch.einsum("bqds,bqs->bqd", hq, C[:, q0:q0 + Q]))
        h = hq[:, -1]
    y = torch.cat(ys, dim=1)
    return y[:, :L] if pad else y


def mamba1_forward(p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """x: (B, L, d) -> (B, L, d)."""
    di, s = cfg.d_inner, cfg.ssm_state
    r = _dt_rank(cfg)
    xz = linear(p["in_proj"], x)
    xin, z = xz[..., :di], xz[..., di:]
    xin = F.silu(_causal_conv(xin, p["conv"], p["conv_b"], cfg.ssm_conv))
    # (x_proj's product, partial sums where a mesh cuts d_inner, summed
    # where the rows are: dt_proj and the scan read it whole)
    proj = settle(linear(p["x_proj"], xin), x)
    delta = F.softplus(linear(p["dt_proj"], proj[..., :r]).float())   # (B, L, di)
    Bm = proj[..., r:r + s].float()                                   # (B, L, s)
    Cm = proj[..., r + s:].float()
    A = -torch.exp(p["A_log"])                                        # (di, s)
    dA = (delta[..., None] * A).exp_()                                # (B, L, di, s)
    xf = xin.float()
    dBx = (delta * xf)[..., None] * Bm[:, :, None, :]
    y = _mamba1_ssm_chunked(dA, dBx, Cm, cfg.ssm_chunk)
    y = y + p["D"] * xf
    return linear(p["out_proj"], y.to(x.dtype) * F.silu(z))


def mamba1_decode(p: dict, cfg, x: torch.Tensor, cache: dict):
    """One-step recurrence. x: (B, 1, d); cache: {"conv": (B, W-1, di),
    "h": (B, di, s)}, both written in place.  Returns (y, cache)."""
    di, s = cfg.d_inner, cfg.ssm_state
    r = _dt_rank(cfg)
    xz = linear(p["in_proj"], x)
    xin, z = xz[..., :di], xz[..., di:]
    win = torch.cat((cache["conv"], xin), dim=1)                 # (B, W, di)
    xc = F.silu(torch.einsum("bwd,dw->bd", win, p["conv"]) + p["conv_b"])[:, None]
    proj = linear(p["x_proj"], xc)
    delta = F.softplus(linear(p["dt_proj"], proj[..., :r]).float())[:, 0]  # (B, di)
    Bm = proj[:, 0, r:r + s].float()
    Cm = proj[:, 0, r + s:].float()
    dA = torch.exp(delta[..., None] * -torch.exp(p["A_log"]))             # (B, di, s)
    xf = xc[:, 0].float()
    h = cache["h"] * dA + (delta * xf)[..., None] * Bm[:, None, :]
    y = torch.einsum("bds,bs->bd", h, Cm) + p["D"] * xf
    cache["conv"].copy_(win[:, 1:])
    cache["h"].copy_(h)
    return linear(p["out_proj"], y[:, None].to(x.dtype) * F.silu(z)), cache


# ===================================================================== Mamba2
def init_mamba2(gen: torch.Generator, cfg) -> dict:
    d, di, s, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dt = torch_dtype(cfg)
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {"in_proj": init_linear(gen, d, 2 * di, dt),           # x and z
            "bc_proj": init_linear(gen, d, 2 * s + H, dt),        # B, C, dt
            **_init_conv(gen, cfg, dt),
            "A_log": torch.zeros((H,), **f32),
            "D": torch.ones((H,), **f32),
            "out_proj": init_linear(gen, di, d, dt, scale=di ** -0.5),
            "dt_bias": torch.zeros((H,), **f32)}


def _ssd_chunk(S0, av, xv, bv, cv):
    """One SSD chunk: decays av (B, Q, H), Δ-scaled inputs xv (B, Q, H, P),
    bv and cv (B, Q, s), the carried state S0 (B, H, s, P).  Returns the
    chunk's outputs (B, Q, H, P) and the state after it."""
    Q = av.shape[1]
    cum = torch.cumsum(torch.log(torch.clamp(av, min=1e-30)), dim=1)   # (B, Q, H)
    # intra-chunk: Gamma[i, j] = prod_{r=j+1..i} a_r  (i >= j), 0 above the
    # diagonal.  The mask goes in before the exp: above it cum_i - cum_j is
    # the decays' logs summed the other way, positive, and past ~88.7 (a
    # 128-step chunk of decays at softplus(0) already gets there) its exp
    # overflows float32.  Masked after the exp, as the reference does, the
    # forward still reads 0 there, but the backward multiplies a zero
    # gradient by that inf and every weight's gradient turns NaN.
    mask = torch.ones((Q, Q), dtype=torch.bool, device=av.device).tril()
    gam = torch.exp(torch.where(mask[None, :, :, None],
                                cum[:, :, None, :] - cum[:, None, :, :], -torch.inf))
    cb = torch.einsum("bis,bjs->bij", cv, bv)                          # (B, Qi, Qj)
    y_intra = torch.einsum("bijh,bjhp->bihp", cb[..., None] * gam, xv)
    # carry-in: C_i (prod_{r<=i} a) S0
    dec = torch.exp(cum)                                               # (B, Q, H)
    y_carry = torch.einsum("bis,bhsp->bihp", cv, S0) * dec[..., None]
    # next state: a_total * S0 + sum_j (prod_{r>j} a) B_j x_j^T
    rev = torch.exp(cum[:, -1:] - cum)                                 # (B, Q, H)
    S = dec[:, -1, :, None, None] * S0 + torch.einsum(
        "bjs,bjhp->bhsp", bv, xv * rev[..., None])
    return y_intra + y_carry, S


def _mamba2_ssd_chunked(a: torch.Tensor, xd: torch.Tensor, Bm: torch.Tensor,
                        Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """Scalar-per-head recurrence S_t = a_t S_{t-1} + B_t xd_t^T, y_t =
    C_t S_t, chunk by chunk.  a: (B, L, H); xd: (B, L, H, P) (Δ-scaled
    inputs); Bm, Cm: (B, L, s).  Returns y: (B, L, H, P).  Of DTensors, on
    each rank's rows and heads (the chunks run along L)."""
    from torch.distributed.tensor import DTensor
    if isinstance(xd, DTensor):
        at = keep_shards(xd, (0, 2))
        c_at, c_grad = _shared_operand(at)
        return on_shards(lambda a_, x_, b_, c_: _mamba2_ssd_chunked(a_, x_, b_, c_, chunk),
                         (a, xd, Bm, Cm), (at, at, c_at, c_at), list(at),
                         (at, at, c_grad, c_grad))
    B, L, H, P = xd.shape
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        xd = F.pad(xd, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    S = xd.new_zeros((B, H, Bm.shape[-1], P))
    ys = []
    for q0 in range(0, L + pad, Q):
        y, S = _ssd_chunk(S, a[:, q0:q0 + Q], xd[:, q0:q0 + Q], Bm[:, q0:q0 + Q],
                          Cm[:, q0:q0 + Q])
        ys.append(y)
    y = torch.cat(ys, dim=1)
    return y[:, :L] if pad else y


def mamba2_forward(p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """SSD (chunked matmul) forward. x: (B, L, d) -> (B, L, d)."""
    B, L, _ = x.shape
    di, s, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.mamba_headdim
    xz = linear(p["in_proj"], x)
    xin, z = xz[..., :di], xz[..., di:]
    xin = F.silu(_causal_conv(xin, p["conv"], p["conv_b"], cfg.ssm_conv))
    bc = linear(p["bc_proj"], x)
    Bm = bc[..., :s].float()                                           # (B, L, s)
    Cm = bc[..., s:2 * s].float()
    delta = F.softplus(bc[..., 2 * s:].float() + p["dt_bias"])         # (B, L, H)
    a = torch.exp(delta * -torch.exp(p["A_log"]))                      # (B, L, H) decay
    xh = xin.reshape(B, L, H, P).float()
    y = _mamba2_ssd_chunked(a, xh * delta[..., None], Bm, Cm, cfg.ssm_chunk)
    y = y + p["D"][:, None] * xh
    return linear(p["out_proj"], y.reshape(B, L, di).to(x.dtype) * F.silu(z))


def mamba2_decode(p: dict, cfg, x: torch.Tensor, cache: dict):
    """One-step recurrence. x: (B, 1, d); cache: {"conv": (B, W-1, di),
    "S": (B, H, s, P)}, both written in place.  Returns (y, cache)."""
    B = x.shape[0]
    di, s, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.mamba_headdim
    xz = linear(p["in_proj"], x)
    xin, z = xz[..., :di], xz[..., di:]
    win = torch.cat((cache["conv"], xin), dim=1)
    xc = F.silu(torch.einsum("bwd,dw->bd", win, p["conv"]) + p["conv_b"])
    bc = linear(p["bc_proj"], x)[:, 0]
    Bm = bc[:, :s].float()
    Cm = bc[:, s:2 * s].float()
    delta = F.softplus(bc[:, 2 * s:].float() + p["dt_bias"])           # (B, H)
    a = torch.exp(delta * -torch.exp(p["A_log"]))
    xf = xc.reshape(B, H, P).float()
    S = cache["S"] * a[:, :, None, None] + torch.einsum(
        "bs,bhp->bhsp", Bm, xf * delta[..., None])
    y = torch.einsum("bhsp,bs->bhp", S, Cm) + p["D"][:, None] * xf
    cache["conv"].copy_(win[:, 1:])
    cache["S"].copy_(S)
    return linear(p["out_proj"], y.reshape(B, 1, di).to(x.dtype) * F.silu(z)), cache
