"""The benchmark's yardstick: one H100's peaks, the operations and bytes of the
port's kernels, and the model flops of a configuration.

Each function is worked out from shapes alone, so a change to the program
cannot move it.  The kernel counts are those ``chip_smoke.py`` used for its
bounds (``ssd_ops``, ``ssd_bytes``, ``ssd_bound``, ``attention_bound``); the
model flops are counted here from the configuration's published sizes.
"""

from __future__ import annotations

#: NVIDIA's data sheet, H100 SXM at its 700 W limit, dense rates
BF16_PEAK = 989e12  # operations/s, bf16 on the tensor cores
HBM_RATE = 3.35e12  # bytes/s


def bound_s(nbytes: int, ops: int) -> tuple[float, str]:
    """Least time in seconds: the bytes over HBM or the operations at the bf16
    tensor-core rate, whichever is longer, and which it was."""
    t_bytes, t_ops = nbytes / HBM_RATE, ops / BF16_PEAK
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ------------------------------------------------------------------ K4, SSD
def ssd_ops(bh: int, s: int, p: int, n: int, q: int, bg: int) -> int:
    """Operations the SSD scan needs, two per multiply-add: C.B^T over the
    causal (i >= j) pairs of each chunk, once per group, since a group's heads
    share B and C; scores.x over the same pairs per batch-head; and per
    batch-head C.state in every chunk but the first (its state is zero) and
    the state update in every chunk but the last (nothing reads it)."""
    pairs, chunks = q * (q + 1) // 2, s // q
    return 2 * (pairs * n * bg * chunks + pairs * p * bh * chunks + 2 * q * n * p * bh * (chunks - 1))


def ssd_bytes(bh: int, s: int, p: int, n: int, bg: int, itemsize: int) -> int:
    """x, B, C read once and y written once in the model dtype; dt (float32)
    read once; A and D (float32) once per batch-head."""
    return (2 * bh * s * p + 2 * bg * s * n) * itemsize + bh * s * 4 + 2 * bh * 4


def ssd_bound(bh: int, s: int, p: int, n: int, q: int, bg: int, itemsize: int) -> tuple[float, str]:
    """Least seconds of one SSD-scan call."""
    return bound_s(ssd_bytes(bh, s, p, n, bg, itemsize), ssd_ops(bh, s, p, n, q, bg))


# ---------------------------------------------------------- K3, attention
def attention_pairs(sq: int, sk: int, causal: bool, q_offset: int = 0) -> int:
    """(query, key) pairs of one head: row i sees min(sk, i + q_offset + 1)
    keys when causal."""
    if not causal:
        return sq * sk
    a = q_offset + 1
    short = min(sq, max(0, sk - a + 1))  # rows that see fewer than sk keys
    return short * a + short * (short - 1) // 2 + (sq - short) * sk


def attention_bound(bh: int, bk: int, sq: int, sk: int, d: int, itemsize: int, causal: bool,
                    q_offset: int = 0) -> tuple[float, str]:
    """Least seconds of one attention call: q, k, v read once and o written
    once, or 4*d operations per attended pair."""
    nbytes = (2 * bh * sq + 2 * bk * sk) * d * itemsize
    return bound_s(nbytes, 4 * d * attention_pairs(sq, sk, causal, q_offset) * bh)


# ------------------------------------------------------------ model flops
def padded_vocab(cfg: dict) -> int:
    m = cfg["pad_vocab_size_multiple"]
    return (cfg["vocab_size"] + m - 1) // m * m


def ssm_dims(cfg: dict) -> dict:
    """A Mamba2 configuration's sizes, by the published names."""
    layer = cfg["mamba2_layer"]
    d_inner = layer["expand"] * cfg["d_model"]
    return {"d_model": cfg["d_model"], "d_inner": d_inner, "heads": d_inner // layer["headdim"],
            "headdim": layer["headdim"], "d_state": layer["d_state"], "ngroups": layer["ngroups"],
            "d_conv": layer["d_conv"], "chunk": layer["chunk_size"], "layers": cfg["n_layer"],
            "vocab": padded_vocab(cfg)}


def ssd_shape(cfg: dict, batch: int, seq: int) -> dict:
    """The arguments of :func:`ssd_bound` for one mixer call over a batch."""
    d = ssm_dims(cfg)
    return {"bh": batch * d["heads"], "s": seq, "p": d["headdim"], "n": d["d_state"],
            "q": min(d["chunk"], seq), "bg": batch * d["ngroups"]}


def forward_flops_per_token(cfg: dict, seq: int) -> float:
    """Model flops of one token's forward pass, two per multiply-add: the
    projections of every Mamba2 layer (z, x, B, C, dt in; out), its depthwise
    convolution, its SSD scan (:func:`ssd_ops` over a row of ``seq`` tokens),
    and the LM head.  The embedding is a lookup; norms and gates are left
    out, as MFU conventionally leaves elementwise work out."""
    d = ssm_dims(cfg)
    dm, di, n, g, h = d["d_model"], d["d_inner"], d["d_state"], d["ngroups"], d["heads"]
    proj = dm * (2 * di + 2 * g * n + h) + di * dm
    conv = d["d_conv"] * (di + 2 * g * n)
    sh = ssd_shape(cfg, 1, seq)
    scan = ssd_ops(sh["bh"], sh["s"], sh["p"], sh["n"], sh["q"], sh["bg"]) / seq
    return d["layers"] * (2 * proj + 2 * conv + scan) + 2 * dm * d["vocab"]


def train_flops_per_token(cfg: dict, seq: int) -> float:
    """Forward and backward: three times the forward's flops (the usual 6N);
    the recomputation that ``remat`` adds is not model work."""
    return 3 * forward_flops_per_token(cfg, seq)
