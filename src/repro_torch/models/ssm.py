"""Mamba2 (SSD, state-space duality) mixer: the train and scoring forward.

The counterparts of ``repro.models.ssm``'s functions of the same names, with
the same cast order.  ``ssd_chunked`` is the chunked SSD algorithm in plain
PyTorch (intra-chunk quadratic term plus an inter-chunk recurrence over
chunk states); ``mamba_mixer`` wraps projections, causal convolutions,
gating and the output norm, and, as in the reference, ``attn_impl ==
"pallas"`` selects the hand-written SSD-scan kernel instead of
``ssd_chunked``.  Serving takes :func:`mamba_prefill`, the mixer that also
returns the state a decode continues from (through ``ssd_chunked``, since the
kernel returns no state, as at ``repro/models/model.py:355,387``), and
:func:`mamba_decode_step`, the O(1) recurrence over that state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed.sharding import constrain
from .ops import rms_norm

__all__ = ["ssd_chunked", "causal_conv1d", "mamba_mixer", "mamba_prefill",
           "mamba_decode_step", "init_ssm_state"]


def ssd_chunked(
    x: torch.Tensor,   # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)  positive (softplus already applied)
    A: torch.Tensor,   # (H,)       negative
    B_: torch.Tensor,  # (B, S, N)
    C_: torch.Tensor,  # (B, S, N)
    D_: torch.Tensor,  # (H,)
    chunk: int = 256,
    h0: torch.Tensor | None = None,  # (B, H, P, N) initial state
    return_state: bool = False,
):
    """y_t = C_t · h_t + D·x_t with h_t = exp(dt_t A) h_{t-1} + dt_t x_t⊗B_t."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    nc = s // q

    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h).float()
    Bc = B_.reshape(b, nc, q, n)
    Cc = C_.reshape(b, nc, q, n)

    la = dtc * A.float()                        # (B,nc,Q,H) log-decay <= 0
    cum = torch.cumsum(la, dim=2)               # inclusive
    total = cum[:, :, -1, :]                    # (B,nc,H)

    # ---- intra-chunk (quadratic within chunk) -----------------------------
    cb = torch.einsum("bcin,bcjn->bcij", Cc.float(), Bc.float())
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    # mask the exponent BEFORE exp: exp of a positive (i<j) difference would
    # overflow to inf and poison gradients through the where
    expnt = torch.where(mask, cum[:, :, :, None, :] - cum[:, :, None, :, :], float("-inf"))
    decay = torch.exp(expnt)  # (B,nc,Qi,Qj,H)
    scores = cb[..., None] * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores.to(x.dtype), xc)

    # ---- chunk states ------------------------------------------------------
    w = torch.exp(total[:, :, None, :] - cum) * dtc          # (B,nc,Q,H)
    states = torch.einsum("bcqh,bcqhp,bcqn->bchpn", w.to(x.dtype), xc, Bc)

    # ---- inter-chunk recurrence over c ------------------------------------
    hprev = h0.float() if h0 is not None else torch.zeros((b, h, p, n), dtype=torch.float32,
                                                          device=x.device)
    entering = []  # the state ENTERING each chunk
    for c in range(nc):
        entering.append(hprev)
        hprev = torch.exp(total[:, c])[..., None, None] * hprev + states[:, c].float()
    hprevs = torch.stack(entering, dim=1)  # (B,nc,H,P,N)

    y_inter = torch.einsum(
        "bcin,bchpn,bcih->bcihp", Cc.float(), hprevs, torch.exp(cum),
    ).to(x.dtype)

    y = (y_intra + y_inter).reshape(b, s, h, p) + x * D_.to(x.dtype)[None, None, :, None]
    if return_state:
        return y, hprev
    return y


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B,S,C), w: (K,C) -> (B,S,C), silu applied.

    ``F.conv1d`` with one group per channel over a left pad of K-1, weight
    ``w.T[:, None, :]``; like JAX's convolution it is a cross-correlation, so
    neither flips the kernel."""
    k, c = w.shape
    xp = F.pad(x.transpose(1, 2), (k - 1, 0))  # (B,C,S+K-1)
    out = F.conv1d(xp, w.T[:, None, :].to(x.dtype), groups=c).transpose(1, 2)
    return F.silu(out + bias.to(x.dtype))


def _project(x: torch.Tensor, params):
    z = torch.matmul(x, params["w_z"])
    xin = torch.matmul(x, params["w_x"])
    B_ = torch.matmul(x, params["w_B"])
    C_ = torch.matmul(x, params["w_C"])
    dt = torch.matmul(x, params["w_dt"])
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    return z, xin, B_, C_, dt


def mamba_mixer(x: torch.Tensor, params, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Mamba2 block (train / scoring).  x: (B,S,D) -> (B,S,D)."""
    b, s, _ = x.shape
    di, hds, p = cfg.d_inner, cfg.ssm_heads, cfg.ssm.head_dim
    z, xin, B_, C_, dt = _project(x, params)
    xin = causal_conv1d(xin, params["conv_x"], params["conv_x_b"])
    B_ = causal_conv1d(B_, params["conv_B"], params["conv_B_b"])
    C_ = causal_conv1d(C_, params["conv_C"], params["conv_C_b"])
    xh = xin.reshape(b, s, hds, p)
    xh = constrain(xh, "batch", "seq", "ssm_heads", None)
    A = -torch.exp(params["A_log"].float())
    if cfg.attn_impl == "pallas":
        from ..kernels.ssd_scan import ops as ssd_ops

        y = ssd_ops.ssd_scan(xh, dt, A, B_, C_, params["D_skip"], chunk=cfg.ssm.chunk)
    else:
        y = ssd_chunked(xh, dt, A, B_, C_, params["D_skip"], chunk=cfg.ssm.chunk)
    y = y.reshape(b, s, di)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return torch.matmul(y, params["out_proj"])


def _ssd_with_state(xh, dt, A, B_, C_, D_, chunk: int):
    """``ssd_chunked(..., return_state=True)`` over a sequence of any length.

    The reference refuses a length above the chunk that is not a multiple of
    it; here the ragged tail runs as one more, shorter chunk that starts from
    the state the full chunks leave, which is the same recurrence."""
    s = xh.shape[1]
    q = min(chunk, s)
    head = s - s % q
    if head == s:
        return ssd_chunked(xh, dt, A, B_, C_, D_, chunk=q, return_state=True)
    y1, h1 = ssd_chunked(xh[:, :head], dt[:, :head], A, B_[:, :head], C_[:, :head], D_,
                         chunk=q, return_state=True)
    y2, h2 = ssd_chunked(xh[:, head:], dt[:, head:], A, B_[:, head:], C_[:, head:], D_,
                         chunk=s - head, h0=h1, return_state=True)
    return torch.cat([y1, y2], dim=1), h2


def mamba_prefill(x: torch.Tensor, params, cfg: ModelConfig):
    """The mixer over a prompt, with the state a decode continues from.
    x: (B,S,D) -> (y (B,S,D), conv state (B, d_conv-1, d_inner+2N) of the
    last d_conv-1 *pre-conv* inputs, ssm state (B,H,P,N) float32).

    A prompt shorter than d_conv-1 is refused: the reference's conv state
    then has the wrong shape, and its decode fails."""
    b, s, _ = x.shape
    k1 = cfg.ssm.d_conv - 1
    if s < k1:
        raise ValueError(f"a prompt of {s} tokens is shorter than the conv window's "
                         f"d_conv-1 = {k1}")
    di, hds, p = cfg.d_inner, cfg.ssm_heads, cfg.ssm.head_dim
    z, xin, B_, C_, dt = _project(x, params)
    xin_c = causal_conv1d(xin, params["conv_x"], params["conv_x_b"])
    B_c = causal_conv1d(B_, params["conv_B"], params["conv_B_b"])
    C_c = causal_conv1d(C_, params["conv_C"], params["conv_C_b"])
    xh = xin_c.reshape(b, s, hds, p)
    A = -torch.exp(params["A_log"].float())
    y, hstate = _ssd_with_state(xh, dt, A, B_c, C_c, params["D_skip"], cfg.ssm.chunk)
    y = y.reshape(b, s, di)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    conv_state = torch.cat([xin[:, -k1:], B_[:, -k1:], C_[:, -k1:]], dim=-1)
    return torch.matmul(y, params["out_proj"]), conv_state, hstate


def init_ssm_state(cfg: ModelConfig, batch: int, dtype, device=None) -> dict:
    """Zeroed decode state of one layer: ``conv`` in ``dtype``, ``ssm`` float32."""
    di, n = cfg.d_inner, cfg.ssm.d_state
    return {
        "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, di + 2 * n), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm.head_dim, n), dtype=torch.float32,
                           device=device),
    }


def mamba_decode_step(x: torch.Tensor, state: dict, params, cfg: ModelConfig):
    """One-token recurrent step.  x: (B,1,D) -> (y (B,1,D), new state)."""
    b = x.shape[0]
    di, n, hds, p = cfg.d_inner, cfg.ssm.d_state, cfg.ssm_heads, cfg.ssm.head_dim
    z, xin, B_, C_, dt = _project(x, params)
    conv_in = torch.cat([xin, B_, C_], dim=-1)  # (B,1,di+2n)
    window = torch.cat([state["conv"], conv_in], dim=1)  # (B,K,di+2n)
    w_full = torch.cat([params["conv_x"], params["conv_B"], params["conv_C"]], dim=-1).to(x.dtype)
    b_full = torch.cat([params["conv_x_b"], params["conv_B_b"], params["conv_C_b"]], dim=-1).to(x.dtype)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, w_full) + b_full)[:, None, :]
    new_conv = window[:, 1:, :]
    xin, B_, C_ = torch.split(conv_out, [di, n, n], dim=-1)
    xh = xin.reshape(b, hds, p)
    A = -torch.exp(params["A_log"].float())
    dt1 = dt[:, 0, :]  # (B,H)
    decay = torch.exp(dt1 * A)  # (B,H)
    h_new = decay[..., None, None] * state["ssm"] + torch.einsum(
        "bh,bhp,bn->bhpn", dt1, xh.float(), B_[:, 0].float())
    y = torch.einsum("bhpn,bn->bhp", h_new, C_[:, 0].float()).to(x.dtype)
    y = y + xh * params["D_skip"].to(x.dtype)[None, :, None]
    y = y.reshape(b, 1, di)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return torch.matmul(y, params["out_proj"]), {"conv": new_conv, "ssm": h_new}
