"""Plain float32 reference of the Mamba2 language model (the ``ssm`` family).

Written from the published description (Mamba2, arXiv:2405.21060: the SSD
layer in its chunked "minimal" form, the gated RMSNorm, the depthwise causal
convolution over x, B and C) and the configuration's published names.  It
imports nothing of the program: the benchmark makes the weights, hands the
same values to both sides, and this module works everything else out again.

Parameters are a tree ``{"embed", "blocks": [per-layer dict], "final_norm"}``
and, unless the configuration ties the LM head to the embedding, ``"lm_head"``,
named as the benchmark's weight maker names them.  Every
computation runs in float32 with TF32 off.  ``quant="fp8"`` is the control,
the model computed in float8 e4m3 (one scale per tensor) wherever the
configuration's dtype, bf16, holds a tensor: the weights, the products'
outputs and every activation between operations, with float32 sums as the
program's bf16 path has them; dt, A and D stay float32 as they do there.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.roofline import ssm_dims

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def param_shapes(cfg: dict) -> dict:
    """Every parameter as (shape, how it is drawn, the draw's argument), in
    the tree's layout.  The draws are those of the published model's own
    initialisation (mamba_ssm's ``Mamba2`` and ``_init_weights``), with
    normal draws where it draws uniformly, of the same variance: projections
    std 1/sqrt(3 fan_in), the output projection that much over sqrt(layers),
    embedding and an untied LM head std 0.02, dt's bias the inverse softplus of a
    log-uniform dt in [dt_min, dt_max], A in the init range, D and norms 1."""
    d = ssm_dims(cfg)
    layer_cfg = cfg["mamba2_layer"]
    dm, di, h, k, n_layer = d["d_model"], d["d_inner"], d["heads"], d["d_conv"], d["layers"]
    gn = d["ngroups"] * d["d_state"]
    proj, conv = (3 * dm) ** -0.5, (3 * k) ** -0.5
    dt = (layer_cfg["dt_min"], layer_cfg["dt_max"], layer_cfg["dt_init_floor"])
    layer = {
        "norm_in": ((dm,), "ones", None), "w_z": ((dm, di), "normal", proj),
        "w_x": ((dm, di), "normal", proj), "w_B": ((dm, gn), "normal", proj),
        "w_C": ((dm, gn), "normal", proj), "w_dt": ((dm, h), "normal", proj),
        "dt_bias": ((h,), "dt_bias", dt), "conv_x": ((k, di), "normal", conv),
        "conv_x_b": ((di,), "uniform", k ** -0.5), "conv_B": ((k, gn), "normal", conv),
        "conv_B_b": ((gn,), "uniform", k ** -0.5), "conv_C": ((k, gn), "normal", conv),
        "conv_C_b": ((gn,), "uniform", k ** -0.5), "A_log": ((h,), "a_log", tuple(layer_cfg["A_init_range"])),
        "D_skip": ((h,), "ones32", None), "norm": ((di,), "ones", None),
        "out_proj": ((di, dm), "normal", (3 * di * n_layer) ** -0.5),
    }
    tree = {"embed": ((d["vocab"], dm), "normal", 0.02), "blocks": [dict(layer) for _ in range(n_layer)],
            "final_norm": ((dm,), "ones", None)}
    if not cfg["tie_embeddings"]:
        tree["lm_head"] = ((dm, d["vocab"]), "normal", 0.02)
    return tree


@contextlib.contextmanager
def exact_float32():
    """TF32 off for the products, restored afterwards."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at one scale for the tensor; the gradient
    passes straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x.detach())


def _q(x: torch.Tensor, quant: str | None) -> torch.Tensor:
    """x as the model dtype holds it: float8 under the control, else float32."""
    return _fp8(x) if quant == "fp8" else x


def _mm(a: torch.Tensor, w: torch.Tensor, quant: str | None) -> torch.Tensor:
    return _q(_q(a, quant) @ _q(w, quant), quant)


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[t] = silu(b + sum_k w[k] x[t - K + 1 + k]), x (B, S, C), w (K, C)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return F.silu(b + sum(w[i] * xp[:, i:i + s] for i in range(k)))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = a[..., j+1] + ... + a[..., i] for i >= j, -inf above."""
    t = a.shape[-1]
    a = a[..., None].expand(*a.shape, t)  # a[..., i, j] = a[i]
    below = torch.ones(t, t, dtype=torch.bool, device=a.device).tril(-1)
    s = torch.cumsum(a.masked_fill(~below, 0.0), dim=-2)
    return s.masked_fill(~torch.ones(t, t, dtype=torch.bool, device=a.device).tril(), -math.inf)


def ssd(x, dt, a, b, c, d_skip, chunk: int, groups: int) -> torch.Tensor:
    """The SSD layer, y_t = C_t . h_t + D x_t with h_t = exp(dt_t a) h_{t-1} +
    dt_t x_t B_t^T, in the chunked form of the paper's listing.
    x (B, S, H, P), dt (B, S, H), a (H,), b and c (B, S, G, N), d_skip (H,)."""
    bs, s, h, p = x.shape
    q = min(chunk, s)
    nc = s // q
    head_group = torch.arange(h, device=x.device) // (h // groups)
    xc = (x * dt[..., None]).reshape(bs, nc, q, h, p)
    la = (dt * a).reshape(bs, nc, q, h).permute(0, 3, 1, 2)  # (B, H, C, L)
    cum = torch.cumsum(la, dim=-1)
    bc, cc = b.reshape(bs, nc, q, groups, -1), c.reshape(bs, nc, q, groups, -1)

    # within each chunk
    cb = torch.einsum("bclgn,bcsgn->bcgls", cc, bc)[:, :, head_group]  # (B, C, H, L, S)
    scores = cb * torch.exp(_segsum(la)).permute(0, 2, 1, 3, 4)
    y = torch.einsum("bchls,bcshp->bclhp", scores, xc)

    # each chunk's own state, then the states entering the chunks
    decay_in = torch.exp(cum[..., -1:] - cum)  # (B, H, C, L)
    bh_ = bc[:, :, :, head_group]  # (B, C, L, H, N)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", bh_, decay_in, xc)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(_segsum(F.pad(cum[..., -1], (1, 0))))  # (B, H, C+1, C+1)
    entering = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    ch = cc[:, :, :, head_group]
    y = y + torch.einsum("bclhn,bchpn,bhcl->bclhp", ch, entering, torch.exp(cum))
    return y.reshape(bs, s, h, p) + x * d_skip[:, None]


def mixer(u: torch.Tensor, w: dict, cfg: dict, quant: str | None) -> torch.Tensor:
    """One Mamba2 layer's mixer on its normed input u (B, S, D)."""
    d = ssm_dims(cfg)
    bs, s, _ = u.shape
    eps = cfg["norm_eps"]
    z = _mm(u, w["w_z"], quant)

    def conv(name):
        return _q(_causal_conv(_mm(u, w[f"w_{name}"], quant), _q(w[f"conv_{name}"], quant),
                               _q(w[f"conv_{name}_b"], quant)), quant)
    x, b, c = conv("x"), conv("B"), conv("C")
    dt = F.softplus(_mm(u, w["w_dt"], quant) + _q(w["dt_bias"], quant))
    g = d["ngroups"]
    y = ssd(x.reshape(bs, s, d["heads"], d["headdim"]), dt, -torch.exp(w["A_log"]),
            b.reshape(bs, s, g, -1), c.reshape(bs, s, g, -1), w["D_skip"], d["chunk"], g)
    y = _q(y, quant).reshape(bs, s, -1)
    y = _q(_rmsnorm(_q(y * F.silu(z), quant), _q(w["norm"], quant), eps), quant)
    return _mm(y, w["out_proj"], quant)


def token_losses_sum(weights: dict, cfg: dict, tokens: torch.Tensor, targets: torch.Tensor, *,
                     quant: str | None = None, remat: bool = False,
                     head_rows: int = 2048) -> tuple[torch.Tensor, int]:
    """Sum over the valid (>= 0) targets of -log softmax(logits)[target], and
    their count, for rows ``tokens`` (B, S).  The LM head and its softmax run
    ``head_rows`` tokens at a time; ``remat`` recomputes each layer in the
    backward pass, so that a gradient fits.  A tied head is the embedding's
    transpose."""
    eps = cfg["norm_eps"]
    head_w = weights["embed"].T if cfg["tie_embeddings"] else weights["lm_head"]
    h = _q(weights["embed"], quant)[tokens.long()]
    for w in weights["blocks"]:
        def layer(hh, w=w):
            return _q(hh + mixer(_q(_rmsnorm(hh, _q(w["norm_in"], quant), eps), quant), w, cfg, quant), quant)
        h = checkpoint(layer, h, use_reentrant=False) if remat else layer(h)
    h = _q(_rmsnorm(h, _q(weights["final_norm"], quant), eps), quant).reshape(-1, h.shape[-1])
    t = targets.reshape(-1).long()
    total = h.new_zeros(())
    for i in range(0, h.shape[0], head_rows):
        def head(hx, tx):
            logits = _mm(hx, head_w, quant)
            nll = torch.logsumexp(logits, -1) - logits.gather(-1, tx.clamp(min=0)[:, None])[:, 0]
            return torch.where(tx >= 0, nll, 0.0).sum()
        hx, tx = h[i:i + head_rows], t[i:i + head_rows]
        total = total + (checkpoint(head, hx, tx, use_reentrant=False) if remat else head(hx, tx))
    return total, int((t >= 0).sum())


def loss(weights: dict, cfg: dict, tokens: torch.Tensor, targets: torch.Tensor, *,
         quant: str | None = None, row_block: int = 2) -> float:
    """The mean loss over a batch, ``row_block`` rows at a time."""
    total, count = 0.0, 0
    with torch.no_grad(), exact_float32():
        for i in range(0, tokens.shape[0], row_block):
            s, n = token_losses_sum(weights, cfg, tokens[i:i + row_block], targets[i:i + row_block],
                                    quant=quant)
            total += float(s)
            count += n
    return total / max(count, 1)


# ------------------------------------------------------------------ training
def leaves(tree: dict) -> dict[str, list[torch.Tensor]]:
    """Leaf name -> its tensors (the layers' tensors for a per-layer name)."""
    out = {k: [v] for k, v in tree.items() if k != "blocks"}
    for k in tree["blocks"][0]:
        out[f"blocks.{k}"] = [layer[k] for layer in tree["blocks"]]
    return out


def leaf_norms(tree: dict) -> dict[str, float]:
    """The float64 norm of each leaf, a per-layer name's layers together."""
    return {name: math.sqrt(sum(float(t.detach().double().square().sum()) for t in ts))
            for name, ts in leaves(tree).items()}


def lr_at(step: int, opt: dict) -> float:
    """Linear warm-up, then a cosine from the peak down to a tenth of it."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    return opt["learning_rate"] * warm * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * prog)))


def from_leaves(template: dict, by_name: dict[str, list[torch.Tensor]]) -> dict:
    """The tree shaped like ``template`` holding the tensors of ``by_name``,
    named as :func:`leaves` names them."""
    tree = {k: ts[0] for k, ts in by_name.items() if not k.startswith("blocks.")}
    tree["blocks"] = [{n: by_name[f"blocks.{n}"][i] for n in layer} for i, layer in enumerate(template["blocks"])]
    return tree


def train(weights: dict, cfg: dict, batches: list[tuple[torch.Tensor, torch.Tensor]], opt: dict, *,
          quant: str | None = None, row_block: int = 4) -> dict:
    """AdamW steps over ``batches`` from ``weights`` (float32, not modified):
    each step's mean loss, the first step's clipped gradient norm by leaf,
    and the norm of each leaf's change after the last step.

    The configuration's mixed precision: a float32 master copy and moments;
    the model's parameters are the master rounded to the configuration's
    dtype before each step (``A_log`` and ``D_skip`` stay float32), and the
    computation runs in float32 on them.  Global-norm clipping; decoupled
    weight decay on every leaf but the top-level vectors."""
    dtype = getattr(torch, cfg["dtype"])
    kinds = leaves(param_shapes(cfg))
    master = {name: [t.detach().clone() for t in ts] for name, ts in leaves(weights).items()}
    as_param = {name: torch.float32 if kinds[name][0][1] in ("a_log", "ones32") else dtype for name in master}
    m = {name: [torch.zeros_like(t) for t in ts] for name, ts in master.items()}
    v = {name: [torch.zeros_like(t) for t in ts] for name, ts in master.items()}
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses, first_grad = [], None
    with exact_float32():
        for step, (tokens, targets) in enumerate(batches, start=1):
            params = {name: [t.to(as_param[name], copy=True).float().requires_grad_() for t in ts]
                      for name, ts in master.items()}
            tree = from_leaves(weights, params)
            count = int((targets >= 0).sum())
            total = 0.0
            for i in range(0, tokens.shape[0], row_block):
                s, _ = token_losses_sum(tree, cfg, tokens[i:i + row_block], targets[i:i + row_block],
                                        quant=quant, remat=True)
                (s / count).backward()
                total += float(s.detach())
            losses.append(total / count)
            with torch.no_grad():
                norms = {name: math.sqrt(sum(float(t.grad.double().square().sum()) for t in ts))
                         for name, ts in params.items()}
                gnorm = math.sqrt(sum(x * x for x in norms.values()))
                clip = min(opt["grad_clip"] / max(gnorm, 1e-9), 1.0) if opt["grad_clip"] else 1.0
                if step == 1:
                    first_grad = {name: clip * x for name, x in norms.items()}
                lr = lr_at(step, opt)
                bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
                for name, ts in params.items():
                    decayed = name.startswith("blocks.") or ts[0].ndim >= 2
                    for t, mt, mm, vv in zip(ts, master[name], m[name], v[name]):
                        g = t.grad * clip
                        mm.mul_(b1).add_(g, alpha=1 - b1)
                        vv.mul_(b2).addcmul_(g, g, value=1 - b2)
                        update = (mm / bc1) / (torch.sqrt(vv / bc2) + eps)
                        if decayed:
                            update = update + wd * mt
                        mt.sub_(lr * update)
    start = leaves(weights)
    change = {name: math.sqrt(sum(float((a - b).double().square().sum()) for a, b in zip(ts, start[name])))
              for name, ts in master.items()}
    return {"losses": losses, "first_grad": first_grad, "change": change}
