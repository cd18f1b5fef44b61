"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure:

1. card: the card's name and power limit, the torch and CUDA versions, and
   the nvcc build of every kernel of the path (from the sources in this
   checkout), with ptxas's registers, spills and shared memory of the SSD
   scan's wgmma launch;
2. kernels: 32 float32 fields on the 1801x3600 0.1-degree lat-lon grid,
   made on the card from a numpy seed; for nbits 8, 16 and 24 the CUDA
   pack/unpack kernels must equal their plain PyTorch versions bit for bit,
   ref/scale on the card must equal the CPU's, and the round trip must stay
   within quantum*1.01 + 2 ulp; kernel, plain and library times come from
   CUDA events around runs of back-to-back launches, beside the bound set
   by the card's memory rate;
3. path: the tiered codec deployment (number=0 to a 16-bit DAOS tier, the
   rest to a 24-bit POSIX tier) archives one output step of 2 members x 16
   fields with archive_fields, flushes, and reads it back with
   retrieve_fields("step=0").arrays(); every field must be within its
   tier's quantum, every payload header well formed, and the CUDA kernels
   must have been launched exactly as often as the codec says.  The step
   runs twice: untraced for the numbers, then traced for the span
   breakdown, which splits each codec launch into its host and card steps;
4. attention: the flash-attention kernel against its plain PyTorch version
   at the full-width prefill shape of qwen2.5-3b (16 query heads over 2 KV
   heads, 2048 tokens, head dim 128, bf16, causal), a ragged causal 1000,
   the shapes of tests/test_kernels.py in float32 and bf16, a q_offset
   window and every head dim the source instantiates (2e-4 in float32,
   2e-2 in bf16).  The bf16 wgmma instance is held at every head dim it
   takes (64, 96, 112 and 128) and groups 1, 3 and 8 at phase 5's served
   prompt lengths, Sq < 128, Sq = 1, Sq < Sk with q_offset and
   bidirectional, against the plain version at 2e-2 and against the plain
   version that rounds P to bf16 as the instance does, at one bf16 ulp of
   the output.  Kernel, plain and scaled_dot_product_attention times beside
   the bound at the full-width shape and at zamba2-7b's longest served
   prefill (32 heads, groups 1, head dim 112);
5. serve: qwen2.5-3b at full width (36 layers, bf16, random weights from
   --seed made on the card) behind ServeEngine(max_batch=4, cache_len=2048)
   answers 8 requests of ragged prompt lengths, 16 greedy tokens each; the
   kernel must have been launched once per layer per prefill, every launch
   on the wgmma instance, the first token's logits through the kernel must
   agree with attn_impl="naive", and the batched tokens are compared with
   sequential prefill + decode; the kernel's and scaled_dot_product_attention's
   times at every served length;
6. ssm: the mixer's causal-convolution kernel at the score cell's shape
   (mamba2-370m, 256 x 2048 tokens: x over 2048 channels, B and C over 128,
   bf16, 4 taps) bit for bit against its plain version
   (repro_torch/kernels/causal_conv/ref.py), and the kernel's, the plain
   version's and F.conv1d's times for one mixer's three launches beside the
   byte bound.  The one-pass RMSNorm kernel at both score cells' shapes
   (gated: 256 x 2048 rows of 2048 and 16 x 4096 rows of 2 groups of 3584;
   plain: widths 1024, 3584 and 7168), each called once through its wrapper
   as the models call it (one launch counted), held against its plain
   version (repro_torch/kernels/rms_norm/ref.py) as held_norm says,
   and the kernel's, the plain version's and F.rms_norm's times beside the
   byte bound; zamba2-7b-instruct's gated shape once more in float32, where
   a kernel that drops eps must fail the check.  The SSD-scan kernel against its plain PyTorch version at the shapes
   of tests/test_kernels.py and the reduced configs' in float32 and bf16,
   its chunk-independence case, and in bf16 the zamba2-7b and mamba2-370m
   head and state sizes and the full-width scoring shape (2e-4 in float32,
   5e-2 in bf16).  The split instance (bf16, head dim 64, state 64 or 128)
   is also held against the plain version that rounds its float32 operands
   to the bf16 terms it feeds them as (one bf16 ulp of the output), and each
   of its two launches against its own plain functions: the first's cumsum
   and chunk states (through its check output) and the states entering each
   chunk, the second's output.  Kernel, plain and ssd_chunked times at the
   full-width shape beside the bound, and the time of each of the split
   instance's two launches beside the bytes and operations it must move and
   do, and the C_i . B_j^T tiles the last one makes (once for each group of
   heads).  The split instance reading x and writing y in the mixer's (B, S,
   H, P) layout beside the same inputs flattened to (B*H, S, P), at
   mamba2-370m's 32 heads (state 128) and zamba2-7b-instruct's 112 heads in 2
   groups (state 64): cum, h and y bit for bit, and each launch's time in
   both layouts.
   Then mamba2-370m at full width (48 layers, bf16, random weights from
   --seed made on the card) trains through Trainer with async checkpoints
   to the emulated DAOS FDB: 6 steps of 8 x 2048 tokens, a checkpoint every
   3, one injected failure at step 4 and a resume from step 3, whose
   restored state must equal the saved one leaf by leaf.  The trained
   weights then score a held-out batch through the kernel (one launch per
   layer) and through ssd_chunked, and both losses are printed; the same
   pass with a faulty scan in the kernel's place must lie more than 3e-4
   from ssd_chunked's, each
   layer's launch must agree with the plain version on that layer's inputs,
   and every launch must have run the split instance on the mixer's (B, S,
   H, P) x, with no copy of x or y (the counter's layout "bshp").  The
   per-layer gate
   (repro_torch.kernels.ssd_scan.gate) holds each layer's launch against the
   plain version with split operands on that layer's inputs at one bf16 ulp,
   and both faulty scans, run on the same inputs, must fail it on every
   layer of more than one chunk; the smallest margin is printed.  The
   scoring pass must launch the convolution kernel 3 times a layer (x, B and
   C), each launch bit-equal to the plain version on its own inputs, and
   the norm kernel 48 + 1 times (norm_in, final_norm) and 48 times gated,
   each launch held against the plain version on its own inputs (phase 9's
   restored pass likewise);
7. hammer: the paper's fdb-hammer benchmark (benchmarks/fdb_hammer_torch.py)
   at its field size of 1 MiB.  (a) run_config drives the tiered codec
   deployment with 4 writer/reader threads, 5 output steps of 10 params x 10
   levels each (2000 fields a mode), through the io modes sync, batched and
   async, packing every step batch on the card; every retrieved field must
   be within its tier's quantum of the field the hammer generated, the
   kernels must have been launched exactly as often as the codec says (at
   least once per thread and step), every payload must have its tier's
   header and wire size, and the effective bytes written must be those of
   the 2000 fields; a second, traced run of each mode gives the kernels'
   share of the codec spans.  (b) remote_sweep serves each backend behind
   the asyncio FDB server and hammers it with 1, 2 and 4 spawned client
   processes (raw 1 MiB payloads, 2 steps x 10 x 10).  (c) The workflow
   example examples/nwp_workflow_torch.py runs on the card;
8. families: every other model family at full width, random weights from
   --seed made on the card, attn_impl="pallas".  zamba2-7b (hybrid: 81
   Mamba2 layers and 13 sites of one shared attention block at head dim
   112), granite-moe-3b-a800m (moe: 40 experts, top 8) and mamba2-370m (ssm)
   each answer 8 requests behind ServeEngine(max_batch=4, cache_len=2048),
   16 greedy tokens each, at phase 5's prompt lengths (granite's drawn in
   100-1024, one moe dispatch group); whisper-tiny (audio) encodes 1500
   frames and prefills batch-4 prompts of 64-448 tokens through
   prefill/decode_step, 16 greedy tokens each.  The flash-attention kernel
   must have been launched once per attention site per prefill (13 for
   zamba2, 32 for granite and 4 encoder + 4 self + 4 cross for whisper, all
   on the wgmma instance, the encoder's and the cross
   attention's bidirectional, the cross attention's Sq != Sk); first-token
   logits through the kernel must agree with attn_impl="naive", and for
   zamba2 and mamba2 decode step 1 with a prefill of the prompt and its
   token.  Each model prints its token rates, ms per decode step, peak card
   memory, one profiled decode step, and the kernel's time at its served
   shapes beside scaled_dot_product_attention's and the bound, each launch
   held against the plain version.  Serving launches no norm kernel
   (prefill and decode keep the plain norm).  zamba2-7b-instruct at full
   width scores one row of 4096 tokens under "pallas": the norm kernel 81 +
   1 + 13 + 13 times (norm_in, final_norm, the shared blocks' two norms) and
   81 times gated, each launch held against the plain version on its own
   inputs, and the SSD-scan kernel 81 times on the mixer's (B, S, H, P) x;
9. distributed: a one-rank NCCL process group and a (1, 1) cuda device mesh
   ("data", "model").  Phase 6's last checkpoint of mamba2-370m (bf16
   parameters and float32 optimizer state) is restored onto it through
   CheckpointManager.restore(shardings=), the parameters' shardings from
   make_rules and logical_axes, the optimizer state's from zero_shard_tree
   over "data": every leaf must be a DTensor on the mesh, equal to the
   saved state by its float64 checksum.  The held-out batch of phase 6 is
   scored through the SSD-scan kernel from the restored parameters: every
   launch on the split instance, the loss within 1e-6 of phase 6's, and 3
   launches a layer of the convolution kernel, each bit-equal to the plain
   version on its inputs.
   make_rules is printed for mamba2-370m, qwen2.5-3b and zamba2-7b on
   stand-in (16, 16) and (2, 16, 16) meshes (names and sizes only).  Then
   benchmarks/run_torch.py runs once in a subprocess on the card: every line
   name of benchmarks/run.py in order, a kernel line after each plain
   kernel line (the instance that float32 selects, its launch count, its
   difference from the plain line, which run_torch.py holds within 2e-4 +
   2e-4 relative, K1 exact), and no jax, jaxlib or repro module imported;
10. launch: (a) the dry run (repro_torch.launch.dryrun.run_cell) of
   qwen2.5-3b train_4k, decode_32k, prefill_32k with attn_impl="pallas"
   and long_500k, granite-moe-3b-a800m train_4k (tensor parallelism inside
   its 40 experts), phi3.5-moe-42b-a6.6b train_4k, prefill_32k with
   attn_impl="pallas" and decode_32k (expert parallelism) and zamba2-7b
   long_500k (a decode of one row, the cache length split over "data") on
   the fake (16, 16) mesh, and mamba2-370m train_4k on the fake (2, 16, 16)
   one, one spawned process a cell, in parallel, into a temporary directory: every record ok (a cell that
   dryrun._skip_reason skips is skipped), collective bytes counted,
   model_flops equal to model_flops_for, a pallas prefill's trace through
   the flash-attention operator once per layer; their terms and
   roofline_table_torch.render_table printed.  (b) The built steps at full
   width on make_debug_mesh(), a one-rank NCCL (1, 1) mesh, random bf16
   weights from --seed, cut in traffic only: qwen2.5-3b's build_prefill
   (attn_impl="pallas") over 8 x 8192 tokens, 36 K3 launches all on
   wgmma, each held against the plain version on its first and last 256
   query rows of every head, the logits bit-equal to a direct prefill();
   its build_decode at batch 32 over an 8192-entry cache; mamba2-370m's
   build_train_step over 8 x 2048 tokens, the first loss within 1e-6 of
   train_loss on the same weights and batch.  Then, as DTensors
   (launch.shard_args), granite-moe-3b-a800m's build_prefill over 8 x 4096
   tokens (32 dispatch groups of 1024; 32 K3 launches, held as above), the
   logits bit-equal to prefill() on plain tensors, and zamba2-7b's
   build_decode of one row over a 131072-entry cache (long_500k cut in
   cache length only), its logits bit-equal to decode_step() on plain
   tensors.  Each step: CUDA-event times of 3 runs after a warm-up, its own
   dry run on a fake (1, 1) mesh (flops, bytes, compute_s, memory_s,
   bottleneck), the dry run's peak bytes beside
   torch.cuda.max_memory_allocated, and model_flops / (step_s * peak).

The line before the last is one JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
without the rest of this repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "benchmarks"), str(ROOT)]

from fdb_hammer_torch import TIERED_CODEC_CONFIG  # noqa: E402
from perfbench.roofline import attention_bound, ssd_bound, ssd_bytes, ssd_ops  # noqa: E402
from repro_torch.kernels import launches as launch_count  # noqa: E402
from repro_torch.kernels.flash_attention.ops import attention_pairs  # noqa: E402
from repro_torch.kernels.rms_norm.ref import rms_norm as plain_norm  # noqa: E402
from repro_torch.kernels.ssd_scan.gate import SPLIT_TOL, LayerGate, faulty_scans  # noqa: E402
from repro_torch.roofline import HW  # noqa: E402

F, H, W = 32, 1801, 3600  # one step of the 0.1-degree HRES grid
MEMBERS, PER_MEMBER = 2, 16
NBITS = (8, 16, 24)
TIER_NBITS = {"0": 16, "1": 24}  # number=0 -> hot DAOS tier, else cold POSIX
# peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
HBM_RATE = HW["hbm_bw"]  # bytes/s
F32_PEAK = HW["f32_flops"]  # float32 operations/s outside the tensor cores
BF16_PEAK = HW["peak_flops"]  # bf16 dense operations/s on the tensor cores
ATTN_TOL = {torch.float32: dict(atol=2e-4, rtol=2e-4),  # tests/test_kernels.py:21-22
            torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# the wgmma instance against the plain version that rounds P to bf16 as it
# does: one bf16 ulp of the output (2^-7 relative at the bottom of a binade).
# The rest of the gap to the default plain version is the rounding of P.
ROUND_P_TOL = dict(atol=2e-3, rtol=8e-3)
ZAMBA2_SCALE = 112 ** -0.5  # the published Zamba2's softmax scale at head dim 224: (224 / 2)^-0.5
# float32 noise in the kernel's 2^x can flip one P's bf16 rounding, which moves an
# output by up to one bf16 ulp of P_j |V_jc| / l past ROUND_P_TOL where that P
# carries much of its row (1-3 of 4.7e8 elements a batch at the hybrid cell's
# shape and scale).  More elements than this past ROUND_P_TOL is a wrong kernel.
ROUND_P_MOST_FLIPS = 64
ATTN_FULL = (2, 8, 2048, 128)  # qwen2.5-3b prefill: KV heads, groups, tokens, head dim
ATTN_CASES = [  # (KV heads x batch, groups, Sq, Sk, d, causal, q_offset)
    (2, 8, 1000, 1000, 128, True, 0),  # ragged causal
    *[(b * kh, g, sq, sk, d, causal, 0)  # tests/test_kernels.py:28-34
      for b, sq, sk, kh, g, d in ((1, 128, 128, 1, 1, 64), (2, 256, 256, 2, 3, 64),
                                  (1, 128, 384, 2, 2, 128), (2, 64, 64, 4, 1, 32))
      for causal in (True, False)],
    (1, 1, 64, 192, 64, True, 128),  # the q_offset window, tests/test_kernels.py:48-58
    *[(2, 3, 77, 77, d, True, 0) for d in (16, 32, 96, 112)],  # the other head dims
]
SERVE_REQUESTS, SERVE_TOKENS = 8, 16
SERVE_BATCH, SERVE_CACHE = 4, 2048
SSD_TOL = {torch.float32: dict(atol=2e-4, rtol=2e-4),  # tests/test_kernels.py:96
           torch.bfloat16: dict(atol=5e-2, rtol=5e-2)}
SSD_CARRY_TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_kernels.py:112
# SPLIT_TOL (repro_torch.kernels.ssd_scan.gate): the split instance against
# the plain version that rounds the scores, w*x and h to the bf16 terms it
# feeds them as: one bf16 ulp of the output, plus float32 sums in another
# order near zero
# the split instance's float32 scratch (cumsum, chunk states through the
# first launch's check output, states entering each chunk) against the plain
# functions of its launches: float32 sums of up to a chunk of products in
# another order
SCRATCH_TOL = dict(atol=1e-4, rtol=1e-5)
SSD_CASES = [  # (batch, seq, heads, head dim, state, chunk), float32 and bf16
    (1, 64, 1, 8, 4, 16), (2, 128, 3, 16, 8, 32),  # tests/test_kernels.py:76-83
    (1, 256, 2, 64, 16, 64), (2, 96, 2, 16, 8, 32),
    (2, 128, 4, 16, 16, 32),  # reduced configs: head dim 16, state 16, chunk 32
]
SSD_FULL = (8, 2048, 32, 64, 128, 256)  # mamba2-370m scoring: batch 8 x 2048 tokens
# the split instance in the mixer's (B, S, H, P) layout beside the flat one,
# at each score cell's shape, its whole batch: (batch, seq, heads, state,
# groups of B and C, chunk)
SSD_LAYOUTS = {"mamba2-370m": (256, 2048, 32, 128, 1, 256),
               "zamba2-7b-instruct": (16, 4096, 112, 64, 2, 256)}
# the full-size heads in bf16, as the models run them: float32 sums of a
# 256-row chunk's terms reach a few hundred, and two summation orders then
# differ by more than 2e-4 near zero
SSD_BF16_CASES = [
    (1, 512, 4, 64, 64, 256),  # zamba2-7b: head dim 64, state 64
    (1, 512, 4, 64, 128, 256),  # mamba2-370m: head dim 64, state 128
    SSD_FULL,
]
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, CKPT_EVERY, FAIL_AT = 8, 2048, 6, 3, 4
# the mixer's causal convolution at the score cell's shape (mamba2-370m, 256 x
# 2048 tokens): one mixer's three calls, x over d_inner and B, C over d_state
# channels, d_conv taps, bf16
CONV_FULL = (256, 2048, (2048, 128, 128), 4)
# the one-pass RMSNorm at the score cells' shapes, bf16: (batch, sequence,
# groups, group width, gated) -- mamba2-370m's gated norm and norm_in (256 x
# 2048 tokens), zamba2-7b-instruct's gated norm (2 groups), norm_in and
# pre-FF norm, and its shared blocks' pre-attention norm over concat(h, x0)
# (16 x 4096 tokens)
NORM_SHAPES = ((256, 2048, 1, 2048, True), (16, 4096, 2, 3584, True),
               (256, 2048, 1, 1024, False), (16, 4096, 1, 3584, False),
               (16, 4096, 1, 7168, False))
# zamba2-7b-instruct's gated norm once more in float32, where a kernel that
# drops eps (a relative change of eps / var in the variance, ~1e-6 here) is
# tens of float32 ulps off at most elements, past NORM_ULPS and NORM_DIFFER;
# in bf16 it flips too few roundings for the bf16 check to see it
NORM_F32 = (16, 4096, 2, 3584, True)
NORM_EPS = 1e-5
# zamba2-7b-instruct's score cell's sequence, scored as one row in phase 8
HYBRID_SCORE_SEQ = 4096
# the kernel against the plain version, which differ in the order of the
# float32 sum of squares alone: that moves rsqrt's result by an ulp or so.  In
# bf16 it flips the rounding of g * r at a few elements in a million (one bf16
# ulp each; 1.2e-6 to 7.9e-6 on an H100 at the cells' widths).  In float32
# g * r is the output, so a row whose rsqrt moves moves by an ulp or more in
# most of its elements: 12-22 % of them, up to 3 float32 ulps, on an H100.
# Held on a unit scale, so that each bound is one of the normalised value;
# with the scale, the kernel's output must be its unit-scale output times the
# scale, rounded as ATen rounds it, bit for bit.
NORM_ULPS = {torch.bfloat16: 1, torch.float32: 4}
NORM_DIFFER = {torch.bfloat16: 1e-3, torch.float32: 0.5}
# held-out loss through the kernel against ssd_chunked, both bf16: ssd_chunked
# rounds its scores, chunk states and inter-chunk term to bf16 where the
# kernel keeps float32, in each of 48 layers.  H100 runs measured 2.92e-4 for
# the split instance, 8.08e-4 for a variant of it that only rounds otherwise
# (each product from a zero accumulator), and 1.04e-3 and 1.83e-3 for the
# faulty scans of faulty_scans() (tools/ssd_scan_precision.py): the loss cannot
# tell a new summation order from a fault, so the kernel's loss is printed, not
# held.  Each faulty scan's loss must still lie farther than this from
# ssd_chunked's; the kernel itself is held layer by layer (gate.LayerGate, at
# SPLIT_TOL on each layer's own inputs), where the faulty scans fail by
# hundreds of times the tolerance.
SCORE_TOL = 3e-4
# phase 9 scores the restored weights through the same kernel on the same
# batch as phase 6: the same bits in, the same loss out
RESTORED_SCORE_TOL = 1e-6
# phase 9: the stand-in meshes make_rules is printed for, and the models
DIST_MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}
DIST_RULES_MODELS = ("mamba2-370m", "qwen2.5-3b", "zamba2-7b")
# the line names benchmarks/run.py prints, in order, when artifacts/dryrun is
# absent; its twin must print each, and after each plain kernel line the
# hand-written kernel's line at the same shape, with the instance expected
RUN_LINES = ("fig3_parameter_optimisation(sim)", "fig4_short_scaling(sim)",
             "fig5_profiling(real-daos)", "fig6_long_scaling(sim)", "listing_comparison(real)",
             "fdb_hammer(real-backends)", "churn_interference(real-backends)", "attention_ref_1k",
             "ssd_chunked_512", "grib_pack_8x256x512", "ckpt_async_overlap(real)", "roofline_table")
RUN_KERNEL_LINES = {"attention_ref_1k": ("flash_attention_1k", "flash_attention", "cuda_cores"),
                    "ssd_chunked_512": ("ssd_scan_512", "ssd_scan", "fwd"),
                    "grib_pack_8x256x512": ("grib_pack_kernel_8x256x512", "grib_pack", "grib_pack")}
# first-token logits through the kernel against attn_impl="naive", both bf16:
# the naive path rounds scores, softmax weights and P.V to bf16, where the
# kernel's wgmma instance keeps the scores, m and l in float32 and rounds only
# P to bf16 before P.V, in each of the 36 layers.  8 bf16 ulps at the largest
# logits (magnitude 4 to 8); an H100 run measured 2 (0.0625), as it did for the
# earlier float32 kernel that kept P unrounded.
LOGITS_TOL = 0.25
# phase 8 compares logits in float32, the served bf16 weights cast: decode
# step 1 against a prefill of the prompt and its token, and the kernel against
# naive attention.  An H100 run measured 2.2e-5 to 8.4e-5 for decode against
# prefill (zamba2-7b, mamba2-370m); the reference's hybrid decode fault moves
# reduced zamba2's logits by 0.268.  In bf16 the same comparisons differ by
# 0.23 to 6.4 with random weights at these depths, and every bf16 path lies 1.1
# to 5.1 from the float32 one (PERF.md section 6): no bf16 comparison of
# logits can tell a fault from rounding there, so phase 8 prints them only.
FLOAT32_LOGITS_TOL = 2e-3
# phase 7: the paper's fdb-hammer at the field size its cost model replays
# (simulation.Workload.field_size, 1 MiB); 4 x 5 x 10 x 10 = 2000 fields a mode
HAMMER_SPEC = dict(n_procs=4, n_steps=5, n_params=10, n_levels=10, field_size=1 << 20,
                   codec_nbits=16)
REMOTE_SPEC = dict(n_steps=2, n_params=10, n_levels=10, field_size=1 << 20)
REMOTE_PROCS = (1, 2, 4)
# phase 8: every family at full width.  (published widths, parameters as
# init_params makes them, K3 launches per prefill, the K3 instance at the
# model's head dim, whether decode is held against an extended prefill)
FAMILY_MODELS = {
    "zamba2-7b": (dict(n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
                       d_ff=14336, hybrid_attn_every=6), 6_789_669_584, 13, "wgmma", True),
    "granite-moe-3b-a800m": (dict(n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64),
                             3_375_072_768, 32, "wgmma", False),
    "mamba2-370m": (dict(n_layers=48, d_model=1024), 420_136_448, 0, None, True),
}
MOE_PROMPTS = (100, 1024)  # granite: one dispatch group of group_size 1024 at most
WHISPER_FRAMES, WHISPER_BATCH, WHISPER_PROMPTS = 1500, 4, (64, 448)  # 30 s; 448 target tokens
WHISPER_PREFILLS = 2
# phase 10 (a): the dry-run cells, traced on fake production meshes (arch,
# shape, multi-pod, attn_impl); a cell that dryrun._skip_reason skips
# (long_500k of a full-attention arch) is skipped
LAUNCH_CELLS = (("qwen2.5-3b", "train_4k", False, None), ("qwen2.5-3b", "decode_32k", False, None),
                ("qwen2.5-3b", "prefill_32k", False, "pallas"), ("mamba2-370m", "train_4k", True, None),
                ("qwen2.5-3b", "long_500k", False, None), ("granite-moe-3b-a800m", "train_4k", False, None),
                ("phi3.5-moe-42b-a6.6b", "train_4k", False, None),
                ("phi3.5-moe-42b-a6.6b", "prefill_32k", False, "pallas"),
                ("phi3.5-moe-42b-a6.6b", "decode_32k", False, None), ("zamba2-7b", "long_500k", False, None))
# phase 10 (b): the built steps at full width on a one-rank (1, 1) mesh, cut
# in traffic only: (arch, builder's shape (name, seq, batch, kind), attn_impl)
BUILT_PREFILL = ("qwen2.5-3b", ("prefill_8k", 8192, 8, "prefill"), "pallas")
BUILT_DECODE = ("qwen2.5-3b", ("decode_8k", 8192, 32, "decode"), "naive")
BUILT_TRAIN = ("mamba2-370m", ("train_2k", TRAIN_SEQ, TRAIN_BATCH, "train"), "naive")
# ... and the sharded paths, as DTensors on the same mesh: granite's prefill
# through K3 (32 dispatch groups of 1024 tokens), and zamba2's decode of one
# row, the long_500k path cut in cache length only (524288 entries of 13
# shared sites would take 98 GB)
BUILT_MOE_PREFILL = ("granite-moe-3b-a800m", ("prefill_4k", 4096, 8, "prefill"), "pallas")
BUILT_LONG_DECODE = ("zamba2-7b", ("decode_128k", 131072, 1, "decode"), "naive")
# the built prefill's K3 launches are held against the plain version on the
# first and the last CHECK_ROWS query rows of every head (the plain version
# of all 8192 rows would hold a 34 GB score matrix)
CHECK_ROWS = 256
STEP_RUNS = 3  # timed runs of each built step, after one warm-up
# the built train step's first loss against train_loss on the same weights
# and batch: the same computation
BUILT_LOSS_TOL = 1e-6
WHISPER_WIDTHS = dict(n_layers=4, encoder_layers=4, d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
                      d_ff=1536)


def served_lengths(rng: np.random.Generator) -> list[int]:
    """Phase 5's prompt lengths, the first draws of default_rng(seed): 100 to
    1500 tokens, none a multiple of 128 (each is ragged against 128-row blocks)."""
    return [int(n) + (int(n) % 128 == 0) for n in rng.integers(100, 1501, SERVE_REQUESTS)]


def moe_lengths(rng: np.random.Generator) -> list[int]:
    """Phase 8's granite prompt lengths: 100 to 1024 tokens, so that a batch-1
    prefill is one moe dispatch group (the reference's reshape refuses more
    tokens than its group_size unless they fill whole groups)."""
    return [int(n) for n in rng.integers(MOE_PROMPTS[0], MOE_PROMPTS[1] + 1, SERVE_REQUESTS)]


def wgmma_cases(seed: int) -> list[tuple]:
    """(KV heads x batch, groups, Sq, Sk, d, causal, q_offset) for the bf16
    wgmma instance: every head dim it takes, groups 1, 3 and 8, Sq = Sk at
    each served length, Sq < 128, Sq = 1, Sq < Sk with q_offset, bidirectional."""
    from repro_torch.kernels.flash_attention.kernel import WGMMA_HEAD_DIMS

    shapes = [*((n, n, True, 0) for n in served_lengths(np.random.default_rng(seed))),
              (77, 77, True, 0), (1, 300, True, 299), (200, 645, True, 445), (333, 333, False, 0)]
    return [(2, g, sq, sk, d, causal, off) for d in WGMMA_HEAD_DIMS for g in (1, 3, 8)
            for sq, sk, causal, off in shapes]


def say(msg: str) -> None:
    print(msg, flush=True)


def counted(*names: str) -> dict[str, int]:
    """The kernel launches counted under ``names`` since the counter's last reset."""
    snap = launch_count.snapshot()
    return {name: snap[name] for name in names}


def make_fields(f: int, h: int, w: int, seed: int, device) -> torch.Tensor:
    """Smooth harmonics around a base temperature plus noise, on the card;
    every coefficient and the noise come from numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    lat = torch.linspace(-math.pi / 2, math.pi / 2, h, device=device)[:, None]
    lon = torch.linspace(0, 2 * math.pi, w + 1, device=device)[:-1][None, :]
    noise = torch.from_numpy(rng.standard_normal(h * w, dtype=np.float32)).to(device)
    base = rng.uniform(220.0, 300.0, f)
    amp = rng.uniform(2.0, 30.0, (f, 4))
    kx, ky = rng.integers(1, 12, (f, 4)), rng.integers(1, 8, (f, 4))
    phase = rng.uniform(0, 2 * math.pi, (f, 4))
    shift = rng.integers(0, h * w, f)
    out = torch.empty((f, h, w), dtype=torch.float32, device=device)
    for i in range(f):
        field = torch.full((h, w), float(base[i]), device=device)
        for j in range(4):
            field += float(amp[i, j]) * torch.sin(int(kx[i, j]) * lon + float(phase[i, j])) \
                * torch.cos(int(ky[i, j]) * lat)
        out[i] = field + 0.5 * noise.roll(int(shift[i])).view(h, w)
    return out


def device_ms(fn, launches: int = 20, reps: int = 5, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: one CUDA-event pair around
    ``launches`` back-to-back calls, divided by their count, so the host's
    launch cost hides behind the queued work; the median over ``reps``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def call_ms(fn, reps: int = 20) -> float:
    """Time of one call of ``fn`` from an idle stream, its host-side checks,
    allocation and launch included: a CUDA-event pair around a single call,
    median over ``reps``.  Beside :func:`device_ms` it shows the wrapper's cost."""
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def library_unpack(codes: torch.Tensor, ref: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The one PyTorch call that computes codes*scale + ref per field (int32
    codes promote to float32); timed as the library yardstick, used nowhere
    in the port."""
    return torch.addcmul(ref[:, None, None], codes, scale[:, None, None])


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def within_quantum(x: torch.Tensor, y: torch.Tensor, nbits: int) -> tuple[bool, float]:
    """Per field: max|y - x| <= quantum*1.01 + 2 ulp of max|x|; returns the
    verdict and the largest error as a fraction of its bound."""
    lo = x.amin(dim=(1, 2)).double()
    hi = x.amax(dim=(1, 2)).double()
    quantum = torch.clamp(hi - lo, min=1e-30) / ((1 << nbits) - 1)
    top = x.abs().amax(dim=(1, 2)).cpu().numpy()
    ulp = torch.from_numpy(np.spacing(top).astype(np.float64)).to(x.device)
    bound = quantum * 1.01 + 2 * ulp
    err = (y - x).abs().amax(dim=(1, 2)).double()
    return bool((err <= bound).all()), float((err / bound).max())


def drive_path(x: torch.Tensor, keys: list, *, trace: bool) -> dict:
    """One output step through the tiered codec deployment: archive_fields,
    flush, retrieve_fields("step=0").arrays(), with every check of the
    phase.  The kernel counts are set to 0 just before and read just after."""
    from repro_torch.core import build_fdb
    from repro_torch.core.codec import (
        CODEC_HEADER_SIZE, kernel_launches, parse_header, reset_kernel_launches,
    )

    cfg = json.loads(json.dumps(TIERED_CODEC_CONFIG))
    cfg["trace"] = trace
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fdb_") as root:
        cfg["default"]["inner"]["root"] = root
        with build_fdb(cfg) as fdb:
            torch.cuda.synchronize()
            reset_kernel_launches()
            launch_count.reset()
            t0 = time.perf_counter()
            fdb.archive_fields(keys, x)
            fdb.flush()
            t_archive = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = fdb.retrieve_fields("step=0")
            arrays = got.arrays()
            t_retrieve = time.perf_counter() - t0
            launches = counted("grib_pack", "grib_unpack")
            codec_counts = kernel_launches()

            assert codec_counts == {"pack": 2, "unpack": 2}, codec_counts  # one pack per tier
            assert launches == {"grib_pack": codec_counts["pack"],
                                "grib_unpack": codec_counts["unpack"]}, launches
            assert arrays.shape == x.shape and arrays.dtype == np.float32
            assert np.isfinite(arrays).all()
            index = {k: i for i, k in enumerate(keys)}
            order = [index[k] for k in got.keys]
            assert sorted(order) == list(range(len(keys))), "retrieve did not return every field"
            back = torch.from_numpy(arrays).to(x.device)
            for number, nbits in TIER_NBITS.items():
                sel = [j for j, k in enumerate(got.keys) if k["number"] == number]
                ok, frac = within_quantum(x[[order[j] for j in sel]], back[sel], nbits)
                assert ok, f"tier number={number} outside its {nbits}-bit quantum ({frac:.3f})"
                if not trace:
                    say(f"[path] tier number={number}: {len(sel)} fields, {nbits}-bit, "
                        f"worst error {frac:.3f} of quantum*1.01 + 2 ulp")
            wire = 0
            for k in keys:
                payload = fdb.read(k)
                hdr = parse_header(payload, context=str(k))
                assert (hdr.nbits, hdr.height, hdr.width) == (TIER_NBITS[k["number"]], H, W), hdr
                assert len(payload) == CODEC_HEADER_SIZE + hdr.body_size
                wire += len(payload)
            eff = fdb.stats_snapshot()["effective_bytes_written"]
            assert eff == x.numel() * 4, eff
            spans: dict[str, list] = {}
            for sp in fdb._trace.spans():
                tot = spans.setdefault(sp.name, [0.0, 0])
                tot[0] += sp.duration_s
                tot[1] += 1
    return {"archive_s": t_archive, "retrieve_s": t_retrieve, "launches": launches,
            "codec_counts": codec_counts, "wire": wire, "spans": spans}


def in_ms(bound: tuple[float, str]) -> tuple[float, str]:
    """A bound of ``perfbench/roofline.py`` (seconds, what bounds it) in ms."""
    return bound[0] * 1e3, bound[1]


def held_in_kernel_order(out, q, k, v, *, groups: int, causal: bool, q_offset: int = 0,
                         scale: float | None = None) -> tuple[float, int]:
    """Hold the bf16 wgmma instance's ``out`` at ROUND_P_TOL against the plain
    version in the kernel's own order (P rounded to bf16 at each K/V stage's
    running max).  An element past that tolerance must lie within it plus one
    bf16 ulp (2^-7 relative) of its row's largest P_j |V_jc| / l, the most one
    flipped rounding of P moves it, and at most ROUND_P_MOST_FLIPS elements may.
    Returns the largest gap and the count of elements past ROUND_P_TOL."""
    from repro_torch.kernels.flash_attention.kernel import WGMMA_KEY_BLOCK
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref_blocked

    d = q.shape[-1]
    ref = flash_attention_ref_blocked(q, k, v, groups=groups, causal=causal, q_offset=q_offset, scale=scale,
                                      key_block=WGMMA_KEY_BLOCK[d]).float()
    gap = (out.float() - ref).abs()
    limit = ROUND_P_TOL["atol"] + ROUND_P_TOL["rtol"] * ref.abs()
    past = (gap > limit).nonzero().tolist()
    assert len(past) <= ROUND_P_MOST_FLIPS, (
        f"{len(past)} elements past {ROUND_P_TOL} of the plain version in the kernel's order")
    scale = 1 / math.sqrt(d) if scale is None else scale
    for r, i, c in past:
        kv = r // groups
        scores = (k[kv].float() @ q[r, i].float()) * scale
        if causal:
            scores[i + q_offset + 1:] = -math.inf
        flip = 2.0 ** -7 * float((torch.softmax(scores, 0) * v[kv, :, c].float().abs()).max())
        assert float(gap[r, i, c]) <= float(limit[r, i, c]) + flip, (
            f"element {(r, i, c)}: |kernel - plain| {float(gap[r, i, c]):.4g} is past {float(limit[r, i, c]):.4g} "
            f"by more than one flipped rounding of P ({flip:.4g})")
    return float(gap.max()), len(past)


def attention_phase(dev, seed: int) -> dict:
    """The flash-attention kernel's instances against their plain version, and
    its times."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    gen = torch.Generator(dev).manual_seed(seed)

    def make(bk, groups, sq, sk, d, dtype):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((bk * groups, sq, d), (bk, sk, d), (bk, sk, d))]

    kh, g, s, d = ATTN_FULL
    full = (kh, g, s, s, d, True, 0)
    worst = {name: 0.0 for name in fk.INSTANCES}
    worst_round_p = worst_order = 0.0
    flips = 0
    cases = [(dtype, case, None) for dtype in (torch.bfloat16, torch.float32) for case in [full, *ATTN_CASES]
             if not (dtype == torch.float32 and case == full)]  # the full-width shape is a bf16 shape
    cases += [(torch.bfloat16, case, None) for case in wgmma_cases(seed)]
    # the published Zamba2's softmax scale, (224 / 2)^-0.5, at every d 224 shape
    cases += [(torch.bfloat16, case, ZAMBA2_SCALE) for case in wgmma_cases(seed) if case[4] == 224]
    for dtype, (bk, groups, sq, sk, hd, causal, off), scale in cases:
        q, k, v = make(bk, groups, sq, sk, hd, dtype)
        out = fk.flash_attention_call(q, k, v, groups=groups, causal=causal, q_offset=off, scale=scale)
        ref = flash_attention_ref(q, k, v, groups=groups, causal=causal, q_offset=off, scale=scale)
        torch.cuda.synchronize()
        instance = fk.instance_for(dtype, hd)
        err = float((out.float() - ref.float()).abs().max())
        worst[instance] = max(worst[instance], err)
        torch.testing.assert_close(out.float(), ref.float(), **ATTN_TOL[dtype])
        line = (f"[attention] {instance} {str(dtype)[6:]} q ({bk * groups}, {sq}, {hd}) k ({bk}, {sk}, "
                f"{hd}) causal={causal} q_offset={off}{'' if scale is None else f' scale {scale:.6g}'}: "
                f"max |kernel - plain| {err:.3g}")
        if instance == "wgmma" and scale is None:
            rounded = flash_attention_ref(q, k, v, groups=groups, causal=causal, q_offset=off,
                                          round_p=True, scale=scale)
            err_p = float((out.float() - rounded.float()).abs().max())
            worst_round_p = max(worst_round_p, err_p)
            torch.testing.assert_close(out.float(), rounded.float(), **ROUND_P_TOL)
            line += f", against plain with P in bf16 {err_p:.3g}"
        elif instance == "wgmma":
            # at Zamba2's scale the rows are peakier, and P rounded at a running max
            # parts from P rounded at the row's max by more than an output ulp
            err_o, n = held_in_kernel_order(out, q, k, v, groups=groups, causal=causal, q_offset=off,
                                            scale=scale)
            worst_order, flips = max(worst_order, err_o), flips + n
            line += f", against plain in the kernel's order {err_o:.3g} ({n} past {ROUND_P_TOL} by a flip of P)"
        say(line)
    say(f"[attention] {len(cases)} cases; max |kernel - plain| by instance "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f" (tolerance 2e-4 float32, 2e-2 bf16); wgmma against plain with P in bf16 "
        f"{worst_round_p:.3g} (tolerance {ROUND_P_TOL}); at scale {ZAMBA2_SCALE:.6g} against plain "
        f"in the kernel's order {worst_order:.3g}, {flips} elements past that tolerance by a flip of P")

    def timed(label, kh, g, s, d, scale=None, plain_heads=None):
        """Kernel, plain and SDPA times at one causal bf16 shape, beside its bound,
        after the kernel's output is held against the plain version (and, on the
        wgmma instance, against it in the kernel's order); the plain versions run
        ``plain_heads`` query heads at a time where their scores would not fit at once."""
        q, k, v = make(kh, g, s, s, d, torch.bfloat16)
        call = lambda: fk.flash_attention_call(q, k, v, groups=g, causal=True, scale=scale)  # noqa: E731
        step = plain_heads or kh * g
        instance = fk.instance_for(torch.bfloat16, d)
        out = call()
        err = err_o = 0.0
        n_flips = 0
        for i in range(0, kh * g, step):
            rows, kv = slice(i, i + step), slice(i // g, (i + step) // g)
            ref = flash_attention_ref(q[rows], k[kv], v[kv], groups=g, causal=True, scale=scale)
            err = max(err, float((out[rows].float() - ref.float()).abs().max()))
            torch.testing.assert_close(out[rows].float(), ref.float(), **ATTN_TOL[torch.bfloat16])
            del ref
            if instance == "wgmma":
                gap, n = held_in_kernel_order(out[rows], q[rows], k[kv], v[kv], groups=g, causal=True,
                                              scale=scale)
                err_o, n_flips = max(err_o, gap), n_flips + n
        del out

        def plain():
            for i in range(0, kh * g, step):
                flash_attention_ref(q[i:i + step], k[i // g:(i + step) // g], v[i // g:(i + step) // g],
                                    groups=g, causal=True, scale=scale)
        qs, ks, vs = q[None], k[None], v[None]  # (1, heads, S, d): SDPA's layout, no copy
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qs, ks, vs, is_causal=True, enable_gqa=True, scale=scale)
        lib_err = float((library()[0].float() - call().float()).abs().max())
        timing = {"ms": device_ms(call), "call_ms": call_ms(call),
                  "plain_ms": device_ms(plain, launches=5), "library_ms": device_ms(library)}
        bound, by = in_ms(attention_bound(kh * g, kh, s, s, d, 2, True))
        flops = 4 * d * attention_pairs(s, s, True, 0) * kh * g
        tflops = flops / timing["ms"] / 1e9
        say(f"[attention] {label} q ({kh * g}, {s}, {d}) bf16 causal, scale "
            f"{1 / math.sqrt(d) if scale is None else scale:.6g}, instance {instance}: max |kernel - plain| "
            f"{err:.3g} (tolerance {ATTN_TOL[torch.bfloat16]}), against plain in the kernel's order "
            f"{err_o:.3g} (tolerance {ROUND_P_TOL}; {n_flips} elements past it by a flip of P)")
        say(f"[attention] {label} q ({kh * g}, {s}, {d}) bf16 causal, instance {instance}: kernel "
            f"{timing['ms']:.4f} ms ({tflops:.1f} TFLOP/s, {100 * bound / timing['ms']:.1f} % of the "
            f"bound; one call from idle {timing['call_ms']:.4f} ms), plain {timing['plain_ms']:.4f} ms, "
            f"scaled_dot_product_attention {timing['library_ms']:.4f} ms (max |sdpa - kernel| "
            f"{lib_err:.3g}); bound {bound:.4f} ms by {by} ({flops / 1e9:.2f} GFLOP at "
            f"{BF16_PEAK / 1e12:.0f} TFLOP/s bf16)")
        return {**timing, "bound_ms": bound, "bound_by": by, "instance": instance, "tflops": tflops,
                "max_abs_err": err, "max_abs_err_kernel_order": err_o, "flips_of_p": n_flips}

    full_width = timed("full width", kh, g, s, d)
    # zamba2-7b's shared attention at its longest served prefill: 32 heads of 112, groups 1
    zw = FAMILY_MODELS["zamba2-7b"][0]
    zamba2 = timed("zamba2-7b's longest served prefill", zw["n_kv_heads"], 1,
                   max(served_lengths(np.random.default_rng(seed))), zw["head_dim"])
    # the published Zamba2's shared attention in the benchmark's scoring cell:
    # 16 rows x 32 heads of 224 over 4096 tokens, scale (224 / 2)^-0.5
    instruct = timed("zamba2-7b-instruct's scoring batch", 16 * 32, 1, 4096, 224, scale=ZAMBA2_SCALE,
                     plain_heads=32)
    return {**full_width, "max_abs_err": max(worst.values()), "zamba2": zamba2,
            "zamba2_instruct": instruct}


def profile_call(fn) -> tuple[float, float, list]:
    """One call of ``fn`` (after one warm-up call) under torch.profiler: its
    host wall ms, the ms the card spent in kernels and copies, and the five
    kernels that took the most of it as (name, ms, count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            tot = by_name.setdefault(e.name, [0.0, 0])
            tot[0] += e.time_range.elapsed_us() / 1e3
            tot[1] += 1
    busy = sum(v[0] for v in by_name.values())
    top = sorted(((k, v[0], v[1]) for k, v in by_name.items()), key=lambda kv: -kv[1])[:5]
    return wall * 1e3, busy, top


def serve_phase(dev, seed: int) -> dict:
    """qwen2.5-3b at full width behind ServeEngine, with every check of the phase."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    from repro_torch.serving import Request, ServeEngine

    cfg = dataclasses.replace(get_config("qwen2.5-3b"), attn_impl="pallas")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(dev).manual_seed(seed), device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    say(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} query "
        f"/ {cfg.n_kv_heads} KV heads, head dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.padded_vocab}, {cfg.dtype}: {n_params / 1e9:.3f} B parameters, "
        f"{weight_bytes / 1e9:.2f} GB, made on the card in {time.perf_counter() - t0:.2f} s")
    assert cfg.n_layers == 36 and cfg.d_model == 2048 and weight_bytes > 6.5e9

    rng = np.random.default_rng(seed)
    lengths = served_lengths(rng)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lengths]

    with torch.inference_mode():  # warm-up: cuBLAS handles, allocator, the kernel's library
        warm = ServeEngine(params, cfg, max_batch=1, cache_len=256)
        warm.submit(Request(prompt=prompts[0][:100], max_new_tokens=2))
        warm.run()
        del warm

    engine = ServeEngine(params, cfg, max_batch=SERVE_BATCH, cache_len=SERVE_CACHE)
    reqs = [Request(prompt=p, max_new_tokens=SERVE_TOKENS) for p in prompts]
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    launch_count.reset()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_count.snapshot()["flash_attention"]
    by_instance = launch_count.by("flash_attention", "instance")

    st = engine.stats
    assert len(done) == SERVE_REQUESTS and all(r.done for r in reqs)
    for r in reqs:
        assert len(r.generated) == SERVE_TOKENS, (r.rid, len(r.generated))
        assert all(0 <= t < cfg.vocab for t in r.generated), r.rid
    assert st["prefills"] == SERVE_REQUESTS
    assert launches == cfg.n_layers * st["prefills"], (launches, st["prefills"])
    assert by_instance == {"wgmma": launches}, by_instance
    say(f"[serve] {SERVE_REQUESTS} requests, prompt lengths {lengths}, {SERVE_TOKENS} tokens each, "
        f"max_batch {SERVE_BATCH}, cache_len {SERVE_CACHE}: wall {wall:.3f} s; "
        f"flash_attention launches {launches} = {cfg.n_layers} layers x {st['prefills']} prefills, "
        f"by instance {by_instance}")
    prefill_tps = st["prefill_tokens"] / st["prefill_s"]
    decode_tps = st["decode_tokens"] / st["decode_s"]
    say(f"[serve] prefill {st['prefill_tokens']} tokens in {st['prefill_s']:.3f} s = "
        f"{prefill_tps:.1f} tok/s; decode {st['decode_tokens']} tokens in {st['decode_steps']} "
        f"steps, {st['decode_s']:.3f} s = {decode_tps:.1f} tok/s "
        f"({st['decode_s'] / st['decode_steps'] * 1e3:.2f} ms per step)")

    # the kernel's share: its time at each served prompt's shape, per layer,
    # beside scaled_dot_product_attention's on the same inputs
    import torch.nn.functional as F

    kh, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(dev).manual_seed(seed)
    kernel_s = library_s = 0.0
    per_length = []
    for n in lengths:
        q = torch.randn((kh * g, n, hd), generator=gen, device=dev).bfloat16()
        k = torch.randn((kh, n, hd), generator=gen, device=dev).bfloat16()
        qs, ks = q[None], k[None]
        k_ms = device_ms(lambda: fk.flash_attention_call(q, k, k, groups=g, causal=True))
        l_ms = device_ms(lambda: F.scaled_dot_product_attention(qs, ks, ks, is_causal=True,
                                                                enable_gqa=True))
        kernel_s += cfg.n_layers * k_ms / 1e3
        library_s += cfg.n_layers * l_ms / 1e3
        per_length.append(f"{n}: {k_ms:.4f} / {l_ms:.4f}")
    say(f"[serve] kernel / scaled_dot_product_attention ms at each served length (CUDA events "
        f"around back-to-back calls): " + "; ".join(per_length))
    say(f"[serve] kernel time at the served shapes ({cfg.n_layers} launches per prefill): "
        f"{kernel_s * 1e3:.3f} ms = {100 * kernel_s / wall:.3f} % of the wall time, "
        f"{100 * kernel_s / st['prefill_s']:.3f} % of the prefill time; "
        f"scaled_dot_product_attention at the same shapes {library_s * 1e3:.3f} ms")

    with torch.inference_mode():
        # first-token logits through the kernel and through naive attention
        naive = dataclasses.replace(cfg, attn_impl="naive")
        tokens = torch.tensor(prompts[0], device=dev)[None]
        lk, _ = prefill(params, cfg, tokens, init_cache(cfg, 1, lengths[0], device=dev))
        ln, _ = prefill(params, naive, tokens, init_cache(naive, 1, lengths[0], device=dev))
        logit_err = float((lk.float() - ln.float()).abs().max())
        top = float(ln.float().abs().max())
        say(f"[serve] first-token logits of prompt 0 ({lengths[0]} tokens), kernel vs naive "
            f"attention: max |diff| {logit_err:.4g} (max |logit| {top:.4g}, tolerance "
            f"{LOGITS_TOL}); argmax {int(lk[0, :cfg.vocab].argmax())} vs "
            f"{int(ln[0, :cfg.vocab].argmax())}")
        assert logit_err <= LOGITS_TOL, logit_err

        # batched engine against sequential prefill + greedy decode, per request
        agree = 0
        for p, r in zip(prompts, reqs):
            cache = init_cache(cfg, 1, SERVE_CACHE, device=dev)
            logits, cache = prefill(params, cfg, torch.tensor(p, device=dev)[None], cache)
            seq = [int(logits[0, :cfg.vocab].argmax())]
            for _ in range(SERVE_TOKENS - 1):
                logits, cache = decode_step(params, cfg, torch.tensor([[seq[-1]]], device=dev), cache)
                seq.append(int(logits[0, :cfg.vocab].argmax()))
            agree += sum(a == b for a, b in zip(seq, r.generated))
        say(f"[serve] batched vs sequential greedy tokens: {agree} of "
            f"{SERVE_REQUESTS * SERVE_TOKENS} agree (bf16: batched matmuls may break near-ties)")

        # where the time goes: one prefill of prompt 0 and one batched decode step
        cache = init_cache(cfg, SERVE_BATCH, SERVE_CACHE, device=dev)
        cache["pos"] = torch.tensor(lengths[:SERVE_BATCH], dtype=torch.int32, device=dev)
        step_tokens = torch.tensor([[int(p[-1])] for p in prompts[:SERVE_BATCH]], device=dev)
        for what, fn in (
            (f"prefill of {lengths[0]} tokens", lambda: prefill(
                params, cfg, tokens, init_cache(cfg, 1, SERVE_CACHE, device=dev))),
            (f"decode step at batch {SERVE_BATCH}", lambda: decode_step(
                params, cfg, step_tokens, cache)),
        ):
            wall_ms, busy_ms, top = profile_call(fn)
            say(f"[serve] profiled {what}: wall {wall_ms:.3f} ms, card busy {busy_ms:.3f} ms "
                f"({100 * busy_ms / wall_ms:.1f} %, idle {100 - 100 * busy_ms / wall_ms:.1f} %); "
                "top kernels: " + "; ".join(f"{n[:60]} {t:.3f} ms x{c}" for n, t, c in top))
    return {"launches": launches, "wall_s": wall, "prefill_tps": prefill_tps,
            "decode_tps": decode_tps, "kernel_s": kernel_s, "library_s": library_s}


def ssd_inputs(gen, b, s, h, p, n, dtype, dev):
    """x, dt, A, B, C, D as tests/test_kernels.py:86-91 draws them, on the card."""
    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    x = normal(b, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(normal(b, s, h))
    A = -torch.exp(normal(h))
    B, C = normal(b, s, n).to(dtype), normal(b, s, n).to(dtype)
    return x, dt, A, B, C, torch.ones(h, device=dev)


def ssd_flat(x, dt, A, B, C, D):
    """The kernel's operands, flattened as ops.ssd_scan flattens them."""
    from repro_torch.kernels.ssd_scan.ops import flatten

    xf, dtf, af, df = flatten(x, dt, A, D)
    return xf.contiguous(), dtf.contiguous(), af, B, C, df


def split_launch_work(bh: int, s: int, p: int, n: int, q: int,
                      bg: int) -> dict[str, tuple[int, tuple[tuple[int, float], ...]]]:
    """Per launch of the split instance: the bytes it must move (each input read
    once, each output written once), and the operations the function needs (two
    per multiply-add, as :func:`ssd_ops` counts them), each kind beside the peak
    rate it runs at: the tensor cores' bf16 rate for the products, float32 for
    the state pass."""
    nc, pairs = s // q, q * (q + 1) // 2
    x, rows, bc, h = 2 * bh * s * p, 4 * bh * s, 2 * bg * s * n, 4 * bh * nc * n * p
    return {
        # x, dt, A, B in; cum and the state entering each chunk out.  The chunk
        # states' products, then h_{c+1} = exp(total_c) h_c + S_c
        "ssd_chunk_state": (x + rows + 4 * bh + bc + rows + h,
                            ((2 * q * n * p * bh * (nc - 1), BF16_PEAK), (2 * n * p * bh * (nc - 1), F32_PEAK))),
        # x, dt, cum, h, B, C, D in; y out
        "ssd_chunk_scan": (x + 2 * rows + h + 2 * bc + 4 * bh + x,
                           ((2 * (pairs * n * bg * nc + pairs * p * bh * nc + q * n * p * bh * (nc - 1)),
                             BF16_PEAK),)),
    }


def launch_bound(nbytes: int, work: tuple[tuple[int, float], ...]) -> tuple[float, str]:
    """Least time in ms of a launch of :func:`split_launch_work`: its bytes over
    HBM, or each kind of its operations at its peak rate, whichever is longest."""
    t_bytes, t_ops = nbytes / HBM_RATE, max(ops / peak for ops, peak in work)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def ptxas_lines(log: str, kernel: str) -> dict[str, str]:
    """What ``ptxas -v`` said in ``log`` of each instance of ``kernel``, by its
    mangled name: its registers, stack, spills and static shared memory."""
    out: dict[str, list[str]] = {}
    name = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if kernel in line else None
        elif name is not None and ("spill" in line or "Used" in line):
            out.setdefault(name, []).append(line.replace("ptxas info    :", "").strip())
    return {k: "; ".join(v) for k, v in out.items()}


def split_launch_errors(scan, flat, heads: int, chunk: int) -> dict[str, float]:
    """Each launch of the split instance ``scan`` (a kernel.SplitScan that has
    run) against its plain functions on the same inputs: the first launch run
    again with its check output, its cumsum and chunk states S_c against
    ssd_chunk_state_ref and its h against ssd_state_pass_ref of its own S_c
    (and bit-equal to the main path's h), the second's output against
    ssd_chunk_scan_ref; the largest differences by part."""
    from repro_torch.kernels.ssd_scan import ref as sr

    x, dt, A, B, C, D = flat
    h_main = scan.h.clone()  # the main path's, written without the check output
    states = torch.empty((scan.bh, scan.s // scan.q - 1, scan.n, x.shape[-1]), dtype=torch.float32,
                         device=x.device)
    scan.chunk_state(states)
    torch.cuda.synchronize()
    assert torch.equal(scan.h, h_main), "ssd_chunk_state's h moved with the check output"
    cum, want_states = sr.ssd_chunk_state_ref(x, dt, A, B, heads=heads, chunk=chunk, split_bf16=True)
    h = sr.ssd_state_pass_ref(states, scan.cum, chunk=chunk)
    out = sr.ssd_chunk_scan_ref(x, dt, scan.cum, scan.h, C, B, D, heads=heads, chunk=chunk,
                                split_bf16=True)
    errs = {}
    for name, got, want, tol in (("ssd_chunk_state cum", scan.cum, cum, SCRATCH_TOL),
                                 ("ssd_chunk_state S_c", states, want_states, SCRATCH_TOL),
                                 ("ssd_chunk_state h", scan.h, h, SCRATCH_TOL),
                                 ("ssd_chunk_scan", scan.out, out, SPLIT_TOL)):
        torch.testing.assert_close(got.float(), want.float(), **tol)
        errs[name] = float((got.float() - want.float()).abs().max()) if want.numel() else 0.0
    return errs


def split_layouts(gen, dev) -> dict[str, dict[str, dict[str, float]]]:
    """The split instance reading x and writing y in the mixer's (B, S, H, P)
    layout against the same inputs flattened to (B*H, S, P), at each score
    cell's shape (:data:`SSD_LAYOUTS`): the same bits of cum, h and y; each
    launch's time in both layouts, timed flat, bshp, bshp, flat, printed and
    returned by cell, layout and launch."""
    from repro_torch.kernels.ssd_scan import kernel as sk

    times = {}
    for name, (b, s, h, n, g, chunk) in SSD_LAYOUTS.items():
        x, dt, A, _, _, D = ssd_inputs(gen, b, s, h, 64, n, torch.bfloat16, dev)
        B, C = (torch.randn((b * g, s, n), generator=gen, device=dev).bfloat16() for _ in range(2))
        xf, dtf, af, _, _, df = ssd_flat(x, dt, A, B, C, D)
        scans = {"flat": sk.SplitScan(xf, dtf, af, B, C, df, heads=h // g, chunk=chunk),
                 "bshp": sk.SplitScan(x, dtf, af, B, C, df, heads=h // g, chunk=chunk)}
        for scan in scans.values():
            scan.run()
        torch.cuda.synchronize()
        flat, bshp = scans["flat"], scans["bshp"]
        assert bshp.out.shape == x.shape and bshp.out.is_contiguous(), name
        assert torch.equal(bshp.cum, flat.cum) and torch.equal(bshp.h, flat.h), name
        assert torch.equal(bshp.out, flat.out.reshape(b, h, s, 64).permute(0, 2, 1, 3)), \
            f"{name}: the split instance's (B, S, H, P) output differs from its flat one"
        ms: dict[str, dict[str, list[float]]] = {lay: {"ssd_chunk_state": [], "ssd_chunk_scan": []}
                                                 for lay in scans}
        for lay in ("flat", "bshp", "bshp", "flat"):
            ms[lay]["ssd_chunk_state"].append(device_ms(scans[lay].chunk_state))
            ms[lay]["ssd_chunk_scan"].append(device_ms(scans[lay].chunk_scan))
        times[name] = {lay: {k: statistics.mean(v) for k, v in by.items()} for lay, by in ms.items()}
        t = times[name]
        say(f"[ssm] split instance at {name}'s shape, x ({b}, {s}, {h}, 64), B and C ({b * g}, {s}, "
            f"{n}), chunk {chunk}: cum, h and y of the (B, S, H, P) layout bit-equal to the flat "
            f"layout's; " + ", ".join(
                f"{k} bshp {t['bshp'][k]:.4f} ms, flat {t['flat'][k]:.4f} ms "
                f"({100 * (t['bshp'][k] / t['flat'][k] - 1):+.2f} %)" for k in t["flat"])
            + " (means of two turns, flat bshp bshp flat)")
        del scans, flat, bshp, x, xf
    return times


def ssd_phase(dev, seed: int) -> dict:
    """The SSD-scan kernel's instances against their plain versions, and their times."""
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models.ssm import ssd_chunked

    gen = torch.Generator(dev).manual_seed(seed)
    worst = {name: 0.0 for name in sk.INSTANCES}
    worst_split = 0.0
    worst_launch: dict[str, float] = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, h, p, n, chunk in [*SSD_CASES, *(SSD_BF16_CASES if dtype == torch.bfloat16 else [])]:
            flat = ssd_flat(*ssd_inputs(gen, b, s, h, p, n, dtype, dev))
            out = sk.ssd_scan_call(*flat, heads=h, chunk=chunk)
            ref = ssd_scan_ref(*flat, heads=h, chunk=chunk)
            torch.cuda.synchronize()
            instance = sk.instance_for(dtype, p, n)
            err = float((out.float() - ref.float()).abs().max())
            worst[instance] = max(worst[instance], err)
            torch.testing.assert_close(out.float(), ref.float(), **SSD_TOL[dtype])
            line = (f"[ssm] ssd_scan {instance} {str(dtype)[6:]} x ({b * h}, {s}, {p}) B ({b}, {s}, "
                    f"{n}) chunk {chunk}: max |kernel - plain| {err:.3g} (max |plain| "
                    f"{float(ref.float().abs().max()):.3g})")
            if instance == "split":
                rounded = ssd_scan_ref(*flat, heads=h, chunk=chunk, split_bf16=True)
                err_s = float((out.float() - rounded.float()).abs().max())
                worst_split = max(worst_split, err_s)
                torch.testing.assert_close(out.float(), rounded.float(), **SPLIT_TOL)
                scan = sk.SplitScan(*flat, heads=h, chunk=chunk)
                scan.run()
                assert torch.equal(scan.out, out), "two runs of the split instance differ"
                for k, v in split_launch_errors(scan, flat, h, chunk).items():
                    worst_launch[k] = max(worst_launch.get(k, 0.0), v)
                line += f", against plain with split operands {err_s:.3g}"
            say(line)
    say("[ssm] max |kernel - plain| by instance " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f" (tolerance 2e-4 float32, 5e-2 bf16); split against plain with split operands "
        f"{worst_split:.3g} (tolerance {SPLIT_TOL}); each split launch against its plain function: "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst_launch.items())
        + f" (scratch tolerance {SCRATCH_TOL}, outputs {SPLIT_TOL})")
    # tests/test_kernels.py:100-112: one long chunk against many small ones
    flat = ssd_flat(*ssd_inputs(gen, 1, 128, 2, 8, 4, torch.float32, dev))
    flat = (*flat[:5], torch.zeros_like(flat[5]))
    one = sk.ssd_scan_call(*flat, heads=2, chunk=128)
    many = sk.ssd_scan_call(*flat, heads=2, chunk=16)
    carry_err = float((one - many).abs().max())
    torch.testing.assert_close(one, many, **SSD_CARRY_TOL)
    say(f"[ssm] ssd_scan state carry, chunk 128 vs 16: max |diff| {carry_err:.3g}")

    b, s, h, p, n, chunk = SSD_FULL
    x, dt, A, B, C, D = ssd_inputs(gen, b, s, h, p, n, torch.bfloat16, dev)
    flat = ssd_flat(x, dt, A, B, C, D)
    instance = sk.instance_for(torch.bfloat16, p, n)
    assert instance == "split", instance
    # the kernel as the main path calls it, on the mixer's (B, S, H, P) x
    call = lambda: sk.ssd_scan_call(x, *flat[1:], heads=h, chunk=chunk)  # noqa: E731
    plain = lambda: ssd_scan_ref(*flat, heads=h, chunk=chunk)  # noqa: E731
    chunked = lambda: ssd_chunked(x, dt, A, B, C, D, chunk=chunk)  # noqa: E731
    scan = sk.SplitScan(x, *flat[1:], heads=h, chunk=chunk)
    scan.run()
    launch_ms = {"ssd_chunk_state": device_ms(scan.chunk_state),
                 "ssd_chunk_scan": device_ms(scan.chunk_scan)}
    split_layouts(gen, dev)
    # the kernel, then the yardstick, then the kernel again: a single pair
    # could straddle a change of clocks
    t_kernel = [device_ms(call)]
    t_chunked = device_ms(chunked, launches=5)
    t_kernel.append(device_ms(call))
    timing = {"ms": statistics.mean(t_kernel), "call_ms": call_ms(call),
              "plain_ms": device_ms(plain, launches=5), "chunked_ms": t_chunked}
    bound, by = in_ms(ssd_bound(b * h, s, p, n, chunk, b, 2))
    flops, nbytes = ssd_ops(b * h, s, p, n, chunk, b), ssd_bytes(b * h, s, p, n, b, 2)
    scratch = sum(t.numel() * t.element_size() for t in (scan.cum, scan.h))
    work = split_launch_work(b * h, s, p, n, chunk, b)
    launch_bounds = {k: launch_bound(nb, ops) for k, (nb, ops) in work.items()}
    for k, (nb, ops) in work.items():
        bound_k, by_k = launch_bounds[k]
        say(f"[ssm] {k} at full width: {launch_ms[k]:.4f} ms; it must move {nb / 1e6:.1f} MB "
            f"({nb / HBM_RATE * 1e3:.4f} ms at {HBM_RATE / 1e12:.2f} TB/s) and do "
            + " and ".join(f"{o / 1e9:.2f} GFLOP ({o / pk * 1e3:.4f} ms at {pk / 1e12:.0f} TFLOP/s)"
                           for o, pk in ops)
            + f": bound {bound_k:.4f} ms by {by_k}, {100 * bound_k / launch_ms[k]:.2f} % of it")
    lib = sk.LIBRARY.load()
    per_sm = lib.ssd_chunk_state_blocks_per_sm(n)
    assert per_sm >= 1, per_sm
    say(f"[ssm] ssd_chunk_state makes each chunk's state on wgmma and chains the recurrence across "
        f"its {b * (s // chunk) * -(-h // lib.ssd_chunk_state_group(chunk))} blocks (groups of "
        f"{lib.ssd_chunk_state_group(chunk)} heads, {per_sm} an SM, {lib.ssd_chunk_state_smem(n)} "
        f"bytes of shared memory each); the chunk states never go to memory")
    # ssd_chunk_scan makes each C_i . B_j^T (a 64 x 64 x N tile, j <= i) once for a group of heads
    tiles = (s // chunk) * sum(i + 1 for i in range(-(-chunk // 64)))
    group = lib.ssd_chunk_scan_group(chunk)
    made = b * tiles * -(-h // group)
    say(f"[ssm] ssd_chunk_scan's C_i . B_j^T tiles (64 x 64 x {n}): {made} made, once for each group "
        f"of {group} heads ({2 * made * 64 * 64 * n / 1e9:.2f} GFLOP); once per head would be "
        f"{b * h * tiles} ({2 * b * h * tiles * 64 * 64 * n / 1e9:.2f} GFLOP)")
    say(f"[ssm] ssd_scan full width x ({b}, {s}, {h}, {p}) B ({b}, {s}, {n}) bf16 chunk {chunk}, "
        f"instance {instance}: kernel {timing['ms']:.4f} ms ({t_kernel[0]:.4f} and {t_kernel[1]:.4f} "
        f"around ssd_chunked; {100 * bound / timing['ms']:.2f} % of the bound; "
        f"{flops / timing['ms'] / 1e9:.1f} TFLOP/s of the work the scan needs; one call from idle "
        f"{timing['call_ms']:.4f} ms), plain {timing['plain_ms']:.4f} ms; bound {bound:.4f} ms by "
        f"{by}: {nbytes / 1e6:.1f} MB take {nbytes / HBM_RATE * 1e3:.4f} ms at "
        f"{HBM_RATE / 1e12:.2f} TB/s, {flops / 1e9:.2f} GFLOP take "
        f"{flops / BF16_PEAK * 1e3:.4f} ms at {BF16_PEAK / 1e12:.0f} TFLOP/s bf16")
    say(f"[ssm] split instance's launches at full width (CUDA events around back-to-back "
        f"launches of each): " + ", ".join(f"{k} {v:.4f} ms" for k, v in launch_ms.items())
        + f" (sum {sum(launch_ms.values()):.4f}); its float32 scratch {scratch / 1e6:.1f} MB "
        f"written and read again: with the inputs and output {(nbytes + 2 * scratch) / 1e6:.1f} "
        f"MB, {(nbytes + 2 * scratch) / HBM_RATE * 1e3:.4f} ms at {HBM_RATE / 1e12:.2f} TB/s")
    say(f"[ssm] yardstick, not a library call: ssd_chunked (plain PyTorch, the training path) "
        f"at the same shape {timing['chunked_ms']:.4f} ms, {timing['chunked_ms'] / timing['ms']:.2f}x "
        f"the kernel's time; library_ms of ssd_scan: none, no single PyTorch call computes the SSD scan")
    assert timing["ms"] < timing["chunked_ms"], (timing, "the split instance is slower than ssd_chunked")
    return {**timing, "max_abs_err": max(worst.values()), "bound_ms": bound, "bound_by": by,
            "library_ms": None, "instance": instance, "launch_ms": launch_ms,
            "launch_bound_ms": {k: v[0] for k, v in launch_bounds.items()}}


def conv_work(b: int, s: int, widths: tuple[int, ...], k: int, itemsize: int) -> tuple[int, int]:
    """Bytes and float32 operations of causal convolutions of (b, s, c) inputs,
    one for each width c: every input, weight, bias and output byte moved once;
    k multiply-adds, the bias and silu's exponential, add and division for
    each output element."""
    nbytes = sum((2 * b * s * c + k * c + c) * itemsize for c in widths)
    ops = sum((2 * k + 4) * b * s * c for c in widths)
    return nbytes, ops


def conv_phase(dev, seed: int) -> dict:
    """The causal-convolution kernel at the score cell's shape: bit for bit
    against the plain version, and its, the plain version's and F.conv1d's times."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.causal_conv import kernel as ck
    from repro_torch.kernels.causal_conv import ref as cref

    b, s, widths, k = CONV_FULL
    gen = torch.Generator(dev).manual_seed(seed)
    inputs = [tuple(torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                    for shape in ((b, s, c), (k, c), (c,))) for c in widths]
    errs = []
    for args in inputs:
        out, ref = ck.causal_conv1d_call(*args), cref.causal_conv1d(*args)
        errs.append(float((out.float() - ref.float()).abs().max()))
        assert torch.equal(out, ref), f"conv kernel != plain at {tuple(out.shape)} (max {errs[-1]:.3g})"
        del out, ref
    # the library's yardstick: F.conv1d with its bias and padding on
    # channel-first copies, no silu and no layout change
    channel_first = [(x.transpose(1, 2).contiguous(), w.T[:, None, :].contiguous(), bias)
                     for x, w, bias in inputs]

    def kernel():
        for args in inputs:
            ck.causal_conv1d_call(*args)

    def plain():
        for args in inputs:
            cref.causal_conv1d(*args)

    def library():
        for xt, wt, bias in channel_first:
            Fn.conv1d(xt, wt, bias, padding=k - 1, groups=xt.shape[1])

    # the kernel, then the yardsticks, then the kernel again
    t_kernel = [device_ms(kernel)]
    plain_ms, library_ms = device_ms(plain, launches=5), device_ms(library)
    t_kernel.append(device_ms(kernel))
    ms = statistics.mean(t_kernel)
    nbytes, ops = conv_work(b, s, widths, k, 2)
    bound, by = max((nbytes / HBM_RATE, "bytes"), (ops / F32_PEAK, "operations"))
    bound *= 1e3
    say(f"[conv] causal_conv1d at the score cell's shape, one mixer's three launches (x ({b}, {s}, "
        f"{widths[0]}), B and C ({b}, {s}, {widths[1]}), bf16, {k} taps): bit-equal to the plain "
        f"version; kernel {ms:.4f} ms ({t_kernel[0]:.4f} and {t_kernel[1]:.4f} around the "
        f"yardsticks; {100 * bound / ms:.2f} % of the bound), plain {plain_ms:.4f} ms, library "
        f"F.conv1d {library_ms:.4f} ms; bound {bound:.4f} ms by {by}: {nbytes / 1e9:.3f} GB take "
        f"{nbytes / HBM_RATE * 1e3:.4f} ms at {HBM_RATE / 1e12:.2f} TB/s, {ops / 1e9:.2f} GFLOP take "
        f"{ops / F32_PEAK * 1e3:.4f} ms at {F32_PEAK / 1e12:.0f} TFLOP/s float32")
    assert ms < plain_ms, (ms, plain_ms, "the conv kernel is slower than the plain version")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound,
            "bound_by": by, "max_abs_err": max(errs)}


def norm_work(rows: int, groups: int, width: int, gated: bool, itemsize: int) -> int:
    """Bytes of one norm of ``rows`` rows of ``groups`` groups of ``width``
    channels: x (and the gate z) read once, the output written once, the scale
    read once."""
    n = rows * groups * width
    return ((3 if gated else 2) * n + groups * width) * itemsize


def ulps_apart(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in units in the last place of b's type at b, in float64."""
    bits = {torch.bfloat16: 8, torch.float32: 24}[b.dtype]
    _, e = torch.frexp(b.double())
    return (a.double() - b.double()).abs() / torch.ldexp(torch.ones_like(e, dtype=torch.float64),
                                                         e - bits)


def held_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, z: torch.Tensor | None = None,
              groups: int = 1, call=None) -> dict:
    """The norm kernel's launch ``call`` (by default the kernel's own) against
    the plain version (``plain_norm``, kernels/rms_norm/ref.py) on the same
    inputs, as NORM_ULPS and NORM_DIFFER say;
    raises AssertionError if it is not."""
    from repro_torch.kernels.rms_norm import kernel as nk

    call = call or nk.rms_norm_call
    ones = torch.ones_like(scale)
    unit, unit_plain = call(x, ones, eps, z=z, groups=groups), plain_norm(x, ones, eps, z, groups)
    out, ref = call(x, scale, eps, z=z, groups=groups), plain_norm(x, scale, eps, z, groups)
    apart, scaled_apart = unit != unit_plain, out != ref  # compared where they differ
    ulps = float(ulps_apart(unit[apart], unit_plain[apart]).max()) if apart.any() else 0.0
    err = float((out[scaled_apart].double() - ref[scaled_apart].double()).abs().max()) \
        if scaled_apart.any() else 0.0
    got = {"max_ulps": ulps, "differ": int(apart.sum()) / apart.numel(),
           "differ_scaled": int(scaled_apart.sum()) / apart.numel(), "max_abs_err": err}
    differ, differ_scaled = got["differ"], got["differ_scaled"]
    shape = (tuple(x.shape), groups, z is not None, x.dtype)
    assert out.dtype == ref.dtype and out.shape == ref.shape and out.is_contiguous(), shape
    assert torch.equal(out, unit * scale), (shape, "output != unit-scale output x scale")
    assert ulps <= NORM_ULPS[x.dtype], (shape, got)
    assert differ < NORM_DIFFER[x.dtype] and differ_scaled < NORM_DIFFER[x.dtype], (shape, got)
    return got


def norm_checked(call, held: list):
    """``call`` (the norm kernel's launch), each launch first held against the
    plain version on its own inputs (:func:`held_norm`), into ``held``."""
    def run(x, scale, eps, z=None, groups=1):
        held.append(held_norm(x, scale, eps, z, groups))
        return call(x, scale, eps, z=z, groups=groups)
    return run


def norm_phase(dev, seed: int) -> dict:
    """The one-pass RMSNorm kernel at the score cells' shapes: one call
    through the wrapper as the models make it (one launch counted, held
    against the plain version), and the kernel's, the plain version's and
    (without the gate) F.rms_norm's times beside the byte bound.  Then
    NORM_F32 in float32, held, and with eps dropped, which must fail."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.rms_norm import kernel as nk
    from repro_torch.kernels.rms_norm import ops as nops

    gen = torch.Generator(dev).manual_seed(seed)

    def inputs(b, s, d, gated, dtype):
        x, z = (torch.randn((b, s, d), generator=gen, device=dev).mul_(2).to(dtype)
                if i == 0 or gated else None for i in range(2))
        return x, z, torch.randn((d,), generator=gen, device=dev).to(dtype)

    rows_out, errs, ulps = [], [], []
    for b, s, groups, width, gated in NORM_SHAPES:
        rows, d = b * s, groups * width
        x, z, scale = inputs(b, s, d, gated, torch.bfloat16)
        held = []
        launch_count.reset()
        with mock.patch.object(nops, "rms_norm_call", norm_checked(nk.rms_norm_call, held)):
            out = nops.rms_norm(x, scale, NORM_EPS, z, groups)
        want = {"gated_rms_norm" if gated else "rms_norm": 1}
        assert launch_count.snapshot() == want and len(held) == 1, (launch_count.snapshot(), len(held))
        assert out.shape == x.shape and out.dtype == x.dtype, (out.shape, out.dtype)
        held = held[0]
        errs.append(held["max_abs_err"])
        ulps.append(held["max_ulps"])
        x2, z2 = x.view(rows, d), None if z is None else z.view(rows, d)
        ms = device_ms(lambda: nk.rms_norm_call(x2, scale, NORM_EPS, z=z2, groups=groups))
        plain_ms = device_ms(lambda: plain_norm(x2, scale, NORM_EPS, z2, groups), launches=5)
        ms = statistics.mean([ms, device_ms(lambda: nk.rms_norm_call(x2, scale, NORM_EPS, z=z2,
                                                                     groups=groups))])
        # the library's yardstick: one call that normalises and scales, with
        # no gate and one scale for the whole row
        library_ms = None if gated or groups > 1 else device_ms(
            lambda: Fn.rms_norm(x2, (width,), scale, NORM_EPS))
        nbytes = norm_work(rows, groups, width, gated, 2)
        bound = nbytes / HBM_RATE * 1e3
        say(f"[norm] {'gated ' if gated else ''}rms_norm of {b} x {s} rows x {groups} group(s) of "
            f"{width} bf16, through the wrapper: 1 launch; kernel {ms:.4f} ms ({100 * bound / ms:.2f} % "
            f"of the bound), plain {plain_ms:.4f} ms, library F.rms_norm "
            f"{'none (it takes no gate)' if library_ms is None else f'{library_ms:.4f} ms'}; bound "
            f"{bound:.4f} ms by bytes: "
            f"{nbytes / 1e9:.3f} GB at {HBM_RATE / 1e12:.2f} TB/s; against the plain version: "
            f"max {held['max_ulps']:.0f} ulp on a unit scale, {held['differ']:.3g} of the elements "
            f"differ ({held['differ_scaled']:.3g} with the scale, max |kernel - plain| "
            f"{held['max_abs_err']:.3g})")
        assert ms < plain_ms, (ms, plain_ms, "the norm kernel is slower than the plain version")
        rows_out.append({"rows": rows, "groups": groups, "width": width, "gated": gated, "ms": ms,
                         "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound, **held})
        del x, z, scale, x2, z2, out
    b, s, groups, width, gated = NORM_F32
    x, z, scale = inputs(b, s, groups * width, gated, torch.float32)
    f32 = held_norm(x, scale, NORM_EPS, z, groups)

    def no_eps(x, scale, eps, z=None, groups=1):
        return nk.rms_norm_call(x, scale, 0.0, z=z, groups=groups)

    try:
        held_norm(x, scale, NORM_EPS, z, groups, call=no_eps)
    except AssertionError as e:
        caught = str(e)
    else:
        raise AssertionError("the float32 check passed a kernel that drops eps")
    say(f"[norm] gated rms_norm of {b} x {s} rows x {groups} groups of {width} float32: max "
        f"{f32['max_ulps']:.0f} ulp on a unit scale (at most {NORM_ULPS[torch.float32]}), "
        f"{f32['differ']:.3g} of the elements differ (under {NORM_DIFFER[torch.float32]}); with eps "
        f"dropped the check fails: {caught[:200]}")
    del x, z, scale
    return {"shapes": rows_out, "max_abs_err": max(errs), "max_ulps": max(ulps), "float32": f32}


def bit_checked(call, plain, errs: list):
    """``call`` (a kernel's launch), held against its plain version ``plain``
    bit for bit on the same inputs at each launch; the largest difference
    goes to ``errs``."""
    def run(*args):
        out = call(*args)
        ref = plain(*args)
        errs.append(float((out.float() - ref.float()).abs().max()))
        assert torch.equal(out, ref), (tuple(out.shape), errs[-1])
        return out
    return run


def checksums(state) -> dict[str, float]:
    """Per reference leaf name, the float64 sum of its values."""
    from repro_torch.tree import leaf_groups

    names, sums = [], []
    for name, group, _ in leaf_groups(state):
        names.append(name)
        sums.append(torch.stack([t.detach().double().sum() for t in group]).sum())
    return dict(zip(names, torch.stack(sums).tolist()))


def checked(call, plain, tol: dict, errs: list):
    """``call`` (a kernel's launch), held against its plain version ``plain``
    on the same inputs at each launch, within ``tol`` of the output's dtype;
    the largest difference goes to ``errs``."""
    def run(*args, **kw):
        out = call(*args, **kw)
        ref = plain(*args, **kw)
        torch.testing.assert_close(out.float(), ref.float(), **tol[out.dtype])
        errs.append(float((out.float() - ref.float()).abs().max()))
        return out
    return run


def train_phase(dev, seed: int) -> dict:
    """mamba2-370m at full width through Trainer with FDB checkpoints and one
    injected failure, then scored through the kernel and through ssd_chunked."""
    import dataclasses

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core import CHECKPOINT_SCHEMA, make_fdb
    from repro_torch.core.daos import DaosEngine
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.causal_conv import ops as cops
    from repro_torch.kernels.rms_norm import ops as nops
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models import train_loss
    from repro_torch.training import Trainer

    cfg = dataclasses.replace(get_config("mamba2-370m"), attn_impl="naive", remat="full")
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm.head_dim,
            cfg.ssm.d_state, cfg.padded_vocab) == (48, 1024, 2048, 32, 64, 128, 50432), cfg
    hp = TrainConfig(learning_rate=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS,
                     checkpoint_every=CKPT_EVERY, async_checkpoint=True, seed=seed)
    fdb = make_fdb("daos", schema=CHECKPOINT_SCHEMA, engine=DaosEngine())
    trainer = Trainer(cfg, hp, fdb, run="mamba2-370m", global_batch=TRAIN_BATCH,
                      seq_len=TRAIN_SEQ, device=dev)
    saved, restored = {}, {}
    save, restore = trainer.ckpt.save, trainer.ckpt.restore

    def save_and_sum(step, state, **kw):
        saved[step] = checksums(state)
        return save(step, state, **kw)

    def restore_and_sum(template, step=None, **kw):
        got, state = restore(template, step, **kw)
        restored[got] = checksums(state)
        return got, state

    trainer.ckpt.save, trainer.ckpt.restore = save_and_sum, restore_and_sum
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = trainer.train(TRAIN_STEPS, fail_at=FAIL_AT, log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    params = trainer.params
    n_params = sum(p.numel() for p in params.parameters())
    say(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, d_inner {cfg.d_inner}, "
        f"{cfg.ssm_heads} SSM heads of {cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}, vocab "
        f"{cfg.padded_vocab}, {cfg.dtype}, attn_impl {cfg.attn_impl}, remat {cfg.remat}: "
        f"{n_params:,} parameters (the analytic param_count() gives {cfg.param_count():,}: it "
        "leaves out dt_bias, the conv biases, the inner norm's extra width and final_norm)")
    # the reference's init_params makes the same leaves at this config
    assert n_params == 420_136_448 and cfg.param_count() == 419_974_144, n_params
    losses = [loss for _, loss in report.losses]
    steady = report.step_s[1:]
    step_med = statistics.median(steady)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    say(f"[train] {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens, checkpoint every "
        f"{CKPT_EVERY} (async, emulated DAOS), failure injected at step {FAIL_AT}: wall {wall:.2f} s, "
        f"{len(report.step_s)} steps taken, restarts {report.restarts}, final step {report.final_step}")
    say(f"[train] step seconds {[round(x, 4) for x in report.step_s]}; median after the first "
        f"{step_med:.4f} s = {tokens / step_med:.1f} tokens/s; peak card memory "
        f"{peak / 1e9:.2f} GB")
    say(f"[train] losses (step, loss): {[(s_, round(x, 5)) for s_, x in report.losses]}")
    for rec in trainer.ckpt.timings:
        if rec["op"] == "save":
            say(f"[train] checkpoint step {rec['step']}: {rec['bytes'] / 1e9:.3f} GB, snapshot to "
                f"host {rec['snapshot_s']:.3f} s (blocks the step loop), write + publish "
                f"{rec['write_s']:.3f} s (writer thread)")
        else:
            say(f"[train] restore step {rec['step']}: {rec['bytes'] / 1e9:.3f} GB in "
                f"{rec['restore_s']:.3f} s")
    assert all(math.isfinite(x) for x in losses), losses
    assert report.restarts == 1 and report.final_step == TRAIN_STEPS, report
    assert list(restored) == [CKPT_EVERY], restored.keys()
    assert restored[CKPT_EVERY] == saved[CKPT_EVERY], "restored state != saved state"
    say(f"[train] restored step {CKPT_EVERY}: {len(restored[CKPT_EVERY])} leaves, every float64 "
        "checksum equal to the saved state's")

    held = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=seed + 1).batch_for_step(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in held.items()}
    kernel_cfg = dataclasses.replace(cfg, attn_impl="pallas")
    with torch.no_grad():
        train_loss(params, kernel_cfg, batch)  # warm-up
        torch.cuda.synchronize()
        launch_count.reset()
        t0 = time.perf_counter()
        lk, _ = train_loss(params, kernel_cfg, batch)
        lk = float(lk)
        kernel_s = time.perf_counter() - t0
        launches, conv_launches = counted("ssd_scan", "causal_conv1d").values()
        by_instance = launch_count.by("ssd_scan", "instance")
        by_layout = launch_count.by("ssd_scan", "layout")
        norm_launches = counted("rms_norm", "gated_rms_norm")
        train_loss(params, cfg, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ln = float(train_loss(params, cfg, batch)[0])
        naive_s = time.perf_counter() - t0
        # the same pass with a faulty scan in the kernel's place: the loss check must see each
        faults = {}
        for what, scan in faulty_scans(sops.ssd_scan).items():
            with mock.patch.object(sops, "ssd_scan", scan):
                faults[what] = float(train_loss(params, kernel_cfg, batch)[0])
        # and every layer's kernel launches against the plain versions on that
        # layer's inputs: the scan's within SSD_TOL, each of the three
        # convolutions' bit for bit, each norm's as held_norm says
        layer_err, conv_err, norm_held = [], [], []
        with mock.patch.object(sops, "ssd_scan_call",
                               checked(sops.ssd_scan_call, ssd_scan_ref, SSD_TOL, layer_err)), \
                mock.patch.object(cops, "causal_conv1d_call",
                                  bit_checked(cops.causal_conv1d_call, cops.ref.causal_conv1d, conv_err)), \
                mock.patch.object(nops, "rms_norm_call", norm_checked(nops.rms_norm_call, norm_held)):
            train_loss(params, kernel_cfg, batch)
        # the gate: each layer's launch against the plain version with split
        # operands at SPLIT_TOL, and both faulty scans on the same inputs
        gate = LayerGate(sops.ssd_scan, faulty_scans(sops.ssd_scan))
        with mock.patch.object(sops, "ssd_scan", gate):
            lg = float(train_loss(params, kernel_cfg, batch)[0])
    say(f"[score] held-out batch {TRAIN_BATCH} x {TRAIN_SEQ}, trained weights: loss through the "
        f"kernel {lk:.6f} ({kernel_s:.3f} s), through ssd_chunked {ln:.6f} ({naive_s:.3f} s); "
        f"|diff| {abs(lk - ln):.3g} (printed; the per-layer gate below holds the kernel); "
        f"ssd_scan launches {launches} = "
        f"{cfg.n_layers} layers x 1 pass, by instance {by_instance}, by layout of x {by_layout}")
    say("[score] faulty scans in the kernel's place, |loss - ssd_chunked's| (each must exceed "
        f"{SCORE_TOL}): " + "; ".join(f"{k} {v:.6f}, {abs(v - ln):.3g}" for k, v in faults.items()))
    say(f"[score] each of the {len(layer_err)} layers' launches against the plain version on its "
        f"own inputs: max |kernel - plain| {max(layer_err):.3g} (bf16 tolerance "
        f"{SSD_TOL[torch.bfloat16]})")
    say(f"[score] causal_conv1d launches {conv_launches} = {cfg.n_layers} layers x 3 (x, B, C); "
        f"each of the {len(conv_err)} against the plain version on its own inputs: bit-equal, "
        f"max |kernel - plain| {max(conv_err):.3g}")
    say(f"[score] rms_norm launches {norm_launches} = {cfg.n_layers} norm_in + 1 final_norm and "
        f"{cfg.n_layers} gated; each of the {len(norm_held)} against the plain version on its own "
        f"inputs: max {max(h['max_ulps'] for h in norm_held):.0f} ulp on a unit scale, at most "
        f"{max(h['differ'] for h in norm_held):.3g} of a launch's elements differ, max |kernel - "
        f"plain| {max(h['max_abs_err'] for h in norm_held):.3g}")
    ratio, layer, fault = gate.margin()
    scan_excess = [rec["scan"] for rec in gate.layers]
    say(f"[score] gate, each of the {len(gate.layers)} layers against the plain version with split "
        f"operands on its own inputs at {SPLIT_TOL}: the kernel at most {max(scan_excess):.3g} of the "
        f"tolerance (max |kernel - plain| {max(r['max_abs_err'] for r in gate.layers):.3g}); "
        f"the faulty scans at least " + ", ".join(
            f"{name} {min(rec[name] for rec in gate.layers if rec['chunks'] > 1):.3g}x"
            for name in gate.faults)
        + f" of it on the {sum(rec['chunks'] > 1 for rec in gate.layers)} layers of more than one "
        f"chunk; smallest margin {ratio:.3g}x ({fault}, layer {layer})")
    say("[score] gate by layer (kernel, " + ", ".join(gate.faults) + "): "
        + " ".join(f"{i}:" + "/".join(f"{rec[k]:.3g}" for k in ("scan", *gate.faults))
                   for i, rec in enumerate(gate.layers)))
    assert math.isfinite(lk) and math.isfinite(ln), (lk, ln)
    assert launches == cfg.n_layers, launches
    assert by_instance == {"split": launches}, by_instance
    assert by_layout == {"bshp": launches}, by_layout  # no scan copies x or y
    assert len(layer_err) == cfg.n_layers, len(layer_err)
    assert conv_launches == len(conv_err) == 3 * cfg.n_layers, (conv_launches, len(conv_err))
    assert norm_launches == {"rms_norm": cfg.n_layers + 1, "gated_rms_norm": cfg.n_layers}, norm_launches
    assert len(norm_held) == 2 * cfg.n_layers + 1, len(norm_held)
    assert len(gate.layers) == cfg.n_layers and lg == lk, (len(gate.layers), lg, lk)
    gate.check()  # the check on the kernel's output: each layer at SPLIT_TOL
    assert all(abs(v - ln) > SCORE_TOL for v in faults.values()), faults
    restore_s = [rec["restore_s"] for rec in trainer.ckpt.timings if rec["op"] == "restore"]
    return {"launches": launches, "step_s": step_med, "losses": losses, "peak": peak,
            "layer_err": max(layer_err), "conv_launches": conv_launches,
            "conv_err": max(conv_err), "norm_launches": sum(norm_launches.values()),
            "norm_err": max(h["max_abs_err"] for h in norm_held), "gate_margin": ratio, "cfg": cfg,
            "fdb": fdb, "run": "mamba2-370m",
            "saved": saved[TRAIN_STEPS], "batch": batch, "kernel_loss": lk,
            "restore_s": restore_s[0]}


def verify_hammer(fh, fdb, spec, dev) -> dict:
    """Read back every field the hammer archived: each decoded field must lie
    within its tier's quantum*1.01 + 2 ulp of the field _step_fields makes
    again, and each payload must carry its tier's header and wire size.
    Returns the worst error as a fraction of its bound and the wire bytes,
    per tier width."""
    from repro_torch.core.codec import parse_header, wire_size

    worst, wire, fields = {16: 0.0, 24: 0.0}, {16: 0, 24: 0}, {16: 0, 24: 0}
    for member in range(spec.n_procs):
        nbits = 16 if member == 0 else 24  # number=0 -> the 16-bit DAOS tier, else 24-bit POSIX
        for step in range(spec.n_steps):
            keys = fh._step_keys(spec, member, step)
            got = fdb.retrieve_fields(fh._step_request(spec, member, step))
            index = {k: i for i, k in enumerate(keys)}
            order = [index[k] for k in got.keys]
            assert sorted(order) == list(range(len(keys))), (member, step)
            x = torch.from_numpy(fh._step_fields(spec, member, step)).to(dev)
            ok, frac = within_quantum(x[order], torch.from_numpy(got.arrays()).to(dev), nbits)
            assert ok, f"member {member} step {step} outside its {nbits}-bit quantum ({frac:.3f})"
            worst[nbits] = max(worst[nbits], frac)
            for k, payload in zip(keys, fdb.read_batch(keys)):
                hdr = parse_header(payload, context=str(k))
                assert (hdr.nbits, hdr.height, hdr.width) == (nbits, *spec.field_shape), hdr
                assert len(payload) == wire_size(spec.field_shape, nbits), len(payload)
                wire[nbits] += len(payload)
            fields[nbits] += len(keys)
    assert fields == {16: spec.fields_per_proc, 24: (spec.n_procs - 1) * spec.fields_per_proc}, fields
    return {"worst": worst, "wire": wire}


def hammer_phase(dev) -> dict:
    """Phase 7: the tiered codec hammer through every io mode, the measured
    remote sweep and the workflow example, with every check of the phase."""
    import fdb_hammer_torch as fh
    from repro_torch.core.codec import kernel_launches, reset_kernel_launches

    gib = 1024 ** 3
    spec = fh.HammerSpec(**HAMMER_SPEC)
    say(f"[hammer] tiered codec deployment: {spec.n_procs} procs x {spec.n_steps} steps x "
        f"{spec.n_params * spec.n_levels} fields of {spec.field_size} B (float32 "
        f"{spec.field_shape[0]} x {spec.field_shape[1]}), {spec.total_bytes / gib:.4f} GiB effective "
        f"a mode; member 0 to the 16-bit DAOS tier, members 1-{spec.n_procs - 1} to the 24-bit POSIX tier")
    modes = {}
    for io in fh.IO_MODES:
        seen: dict = {}
        run_hammer = fh.run_hammer

        def measured(fdb, cell, mode, seen=seen, run_hammer=run_hammer):
            out = run_hammer(fdb, cell, mode)
            seen[mode] = out
            if mode == "retrieve":  # the counts of the hammer's own run, then the check
                torch.cuda.synchronize()
                seen["launches"] = counted("grib_pack", "grib_unpack")
                seen["codec"] = kernel_launches()
                seen["verify"] = verify_hammer(fh, fdb, cell, dev)
            return out

        torch.cuda.synchronize()
        reset_kernel_launches()
        launch_count.reset()
        t0 = time.perf_counter()
        with mock.patch.object(fh, "run_hammer", measured):
            row = fh.run_config(TIERED_CODEC_CONFIG, spec, io_modes=(io,))[0]
        wall = time.perf_counter() - t0
        launches, codec = seen["launches"], seen["codec"]
        assert launches == {"grib_pack": codec["pack"], "grib_unpack": codec["unpack"]}, (launches, codec)
        steps = spec.n_procs * spec.n_steps
        assert codec["pack"] >= steps and codec["unpack"] >= steps, codec
        wire = seen["verify"]["wire"]
        assert row["effective_bytes_written"] == spec.total_bytes, row
        assert row["effective_bytes_read"] == 2 * spec.total_bytes, row  # the hammer's and the check's
        assert row["listed_step0"] == spec.n_procs * spec.n_params * spec.n_levels, row
        assert row["n_parts"] == 2 and all(b >= w for b, w in zip(row["part_bytes_written"],
                                                                 (wire[16], wire[24]))), row

        sink: list = []  # the same mode again, traced, for the span breakdown
        fh.run_config(TIERED_CODEC_CONFIG, spec, io_modes=(io,), trace_sink=sink)
        spans: dict[str, float] = {}
        for sp in sink:
            spans[sp["name"]] = spans.get(sp["name"], 0.0) + sp["t1"] - sp["t0"]
        share = {side: spans[f"codec.{side}.kernel"] / spans[f"codec.{side}"]
                 for side in ("pack", "unpack")}
        w, r = seen["archive"], seen["retrieve"]
        total_wire = wire[16] + wire[24]
        modes[io] = {
            "archive_GiBps": row["write_GiBps"], "retrieve_GiBps": row["read_GiBps"],
            "wire_archive_GiBps": total_wire / w["global_span_s"] / gib,
            "wire_retrieve_GiBps": total_wire / r["global_span_s"] / gib,
            "launches": launches, "share": share, "wall_s": wall,
            "worst": seen["verify"]["worst"],
        }
        m = modes[io]
        say(f"[hammer] io={io}: archive {m['archive_GiBps']:.4f} GiB/s effective "
            f"({m['wire_archive_GiBps']:.4f} wire, span {w['global_span_s']:.3f} s), retrieve "
            f"{m['retrieve_GiBps']:.4f} GiB/s effective ({m['wire_retrieve_GiBps']:.4f} wire, span "
            f"{r['global_span_s']:.3f} s); effective/wire {spec.total_bytes / total_wire:.4f} "
            f"({spec.total_bytes} / {total_wire} B; 16-bit tier {wire[16]} B, 24-bit tier {wire[24]} B)")
        say(f"[hammer] io={io}: kernel launches {launches}, codec counts {codec}; worst error "
            + ", ".join(f"{k}-bit tier {v:.3f}" for k, v in m["worst"].items())
            + " of quantum*1.01 + 2 ulp; traced run: grib_pack "
            f"{100 * share['pack']:.2f} % of codec.pack ({spans['codec.pack']:.3f} s), grib_unpack "
            f"{100 * share['unpack']:.2f} % of codec.unpack ({spans['codec.unpack']:.3f} s); "
            f"mode wall {wall:.2f} s with the check")
        say(f"[hammer] io={io}: traced span seconds, summed over the {spec.n_procs} threads (nested "
            "spans overlap): " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(spans.items(), key=lambda kv: -kv[1])))

    rspec = fh.HammerSpec(**REMOTE_SPEC)
    say(f"[remote] remote_sweep: each backend behind FDBServer, {REMOTE_PROCS} spawned client "
        f"processes x {rspec.fields_per_proc} raw fields of {rspec.field_size} B")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_remote_") as td:
        res = fh.remote_sweep(rspec, backends=("posix", "daos"), procs_list=REMOTE_PROCS,
                              out=str(Path(td) / "remote.json"))
    remote = {}
    for backend in ("posix", "daos"):
        cell = res["backends"][f"{backend}+remote"]
        assert [row["n_procs"] for row in cell["sweep"]] == list(REMOTE_PROCS), cell
        for row in cell["sweep"]:
            n, wire = row["n_procs"], row["wire"]
            payload = n * rspec.fields_per_proc * rspec.field_size
            assert row["measured"] and wire["connections"] >= n, row
            assert wire["bytes_read"] >= payload and wire["bytes_written"] >= payload, wire
            wr, rd = row["write"], row["read"]
            remote[f"{backend}x{n}"] = {"archive_GiBps": wr["agg_GiBps"], "retrieve_GiBps": rd["agg_GiBps"]}
            say(f"[remote] {backend} x{n}: archive {wr['agg_GiBps']:.4f} GiB/s "
                f"({wr['per_proc_GiBps_mean']:.4f} a process), retrieve {rd['agg_GiBps']:.4f} GiB/s "
                f"({rd['per_proc_GiBps_mean']:.4f} a process); server took {wire['bytes_read']} B, "
                f"sent {wire['bytes_written']} B over {wire['connections']} connections")
        say(f"[remote] {backend}: knee at n_procs={cell['knee_n_procs']}")
    say(f"[remote] sweep wall {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    example = subprocess.run([sys.executable, str(ROOT / "examples" / "nwp_workflow_torch.py")],
                             env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                             capture_output=True, text=True, timeout=600)
    assert example.returncode == 0, example.stderr[-4000:]
    assert "GRIB-packed on cuda" in example.stdout, example.stdout
    say(f"[workflow] examples/nwp_workflow_torch.py exit 0 in {time.perf_counter() - t0:.2f} s:\n"
        + example.stdout.rstrip())
    return {"modes": modes, "remote": remote}


def k3_at(gen, dev, bk: int, g: int, sq: int, sk: int, d: int, causal: bool) -> dict:
    """K3 at one served shape, bf16: its time and scaled_dot_product_attention's
    (CUDA events around back-to-back calls), and the kernel held against its
    plain version on the same inputs."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    q = torch.randn((bk * g, sq, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((bk, sk, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((bk, sk, d), generator=gen, device=dev).bfloat16()
    out = fk.flash_attention_call(q, k, v, groups=g, causal=causal)
    ref = flash_attention_ref(q, k, v, groups=g, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), **ATTN_TOL[torch.bfloat16])
    qs, ks, vs = q[None], k[None], v[None]
    return {"ms": device_ms(lambda: fk.flash_attention_call(q, k, v, groups=g, causal=causal)),
            "sdpa_ms": device_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=causal, enable_gqa=True)),
            "err": float((out.float() - ref.float()).abs().max()),
            "instance": fk.instance_for(q.dtype, d)}


def model_params(cfg, dev, seed: int, n_expected: int):
    """Random weights from ``seed``, made on the card; their count must be the
    reference's init_params count at this config."""
    from repro_torch.models import init_params

    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(dev).manual_seed(seed), device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    say(f"[families] {cfg.name} ({cfg.family}): {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} query / {cfg.n_kv_heads} KV heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.padded_vocab}, {cfg.dtype}, attn_impl {cfg.attn_impl}: {n_params:,} parameters, "
        f"{weight_bytes / 1e9:.2f} GB, made on the card in {time.perf_counter() - t0:.2f} s")
    assert n_params == n_expected, (cfg.name, n_params, n_expected)
    return params


def profile_decode(what: str, fn) -> dict:
    wall_ms, busy_ms, top = profile_call(fn)
    say(f"[families] {what}: profiled decode step wall {wall_ms:.3f} ms, card busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f} %, idle {100 - 100 * busy_ms / wall_ms:.1f} %); top kernels: "
        + "; ".join(f"{n[:60]} {t:.3f} ms x{c}" for n, t, c in top))
    return {"wall_ms": wall_ms, "busy_ms": busy_ms}


def float32_twin(params, cfg):
    """The same weights in float32 (each bf16 value exactly), and its config."""
    import dataclasses

    from repro_torch.models import init_params

    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = init_params(c32, torch.Generator(params.device).manual_seed(0), device=params.device)
    p32.copy_from(params.tree())
    return p32, c32


def first_token_checks(params, cfg, tokens, sites: int, check_decode: bool, *,
                       enc_frames=None, enc_len: int = 0) -> dict:
    """The checks of one prompt (``tokens`` (B, S)) beside a served run.

    - Every K3 launch of a bf16 prefill held against the plain version on
      that launch's own inputs.
    - First-token logits through the kernel against ``attn_impl="naive"``,
      both in float32 (the same weights, cast), within FLOAT32_LOGITS_TOL.
    - With ``check_decode``, decode step 1 against a prefill of the prompt
      and its token, in float32, within FLOAT32_LOGITS_TOL.

    The same comparisons in bf16 are printed, not checked: with random
    weights these deep models carry bf16 rounding far (FLOAT32_LOGITS_TOL).
    The audio family passes its ``enc_frames`` and their ``enc_len``."""
    import dataclasses

    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import decode_step, init_cache, prefill

    b, n0 = tokens.shape
    extra = {"enc_frames": enc_frames} if enc_frames is not None else {}

    def first(p, c, impl, toks=tokens, room=1):
        c = dataclasses.replace(c, attn_impl=impl)
        cache = init_cache(c, b, toks.shape[1] + room, enc_len=enc_len, device=tokens.device)
        logits, cache = prefill(p, c, toks, cache, **extra)
        return logits.float(), cache

    out, lines = {}, []
    errs: list = []
    with mock.patch.object(fops, "flash_attention_call",
                           checked(fops.flash_attention_call, flash_attention_ref, ATTN_TOL, errs)):
        lk, cache = first(params, cfg, "pallas")
    assert len(errs) == sites, (len(errs), sites)
    p32, c32 = float32_twin(params, cfg)
    lk32, cache32 = first(p32, c32, "pallas")
    lines.append(f"bf16 kernel vs float32 kernel {float((lk - lk32).abs().max()):.4g}")
    if sites:
        out["k3_model_err"] = max(errs)
        ln, _ = first(params, cfg, "naive")
        ln32, _ = first(p32, c32, "naive")
        out["naive_err"] = float((lk32 - ln32).abs().max())
        lines.append(f"{sites} K3 launches each against plain on its own inputs: max |diff| "
                     f"{max(errs):.3g} (tolerance {ATTN_TOL[torch.bfloat16]}); kernel vs naive in "
                     f"float32 {out['naive_err']:.4g} (tolerance {FLOAT32_LOGITS_TOL}), in bf16 "
                     f"{float((lk - ln).abs().max()):.4g} (argmax {int(lk[0, :cfg.vocab].argmax())} vs "
                     f"{int(ln[0, :cfg.vocab].argmax())}, not checked)")
    if check_decode:
        nxt = lk32[:, :cfg.vocab].argmax(-1)[:, None]
        ld32, _ = decode_step(p32, c32, nxt, cache32)
        le32, _ = first(p32, c32, "pallas", torch.cat([tokens, nxt], dim=1))
        out["decode_err"] = float((ld32 - le32.float()).abs().max())
        ld, _ = decode_step(params, cfg, nxt, cache)
        le, _ = first(params, cfg, "pallas", torch.cat([tokens, nxt], dim=1))
        lines.append(f"decode step 1 vs prefill of the prompt + its token in float32 "
                     f"{out['decode_err']:.4g} (tolerance {FLOAT32_LOGITS_TOL}), in bf16 "
                     f"{float((ld.float() - le.float()).abs().max()):.4g} (not checked)")
    say(f"[families] {cfg.name}: prompt of {b} x {n0} tokens (max |logit| "
        f"{float(lk32.abs().max()):.4g}): " + "; ".join(lines))
    assert out.get("naive_err", 0.0) <= FLOAT32_LOGITS_TOL, (cfg.name, out)
    assert out.get("decode_err", 0.0) <= FLOAT32_LOGITS_TOL, (cfg.name, out)
    del p32, cache32, cache
    return out


def serve_family(dev, seed: int, arch: str) -> dict:
    """One model of phase 8 at full width behind ServeEngine(max_batch=4,
    cache_len=2048): 8 requests, 16 greedy tokens each, with every check."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.serving import Request, ServeEngine

    widths, n_params, sites, instance, check_decode = FAMILY_MODELS[arch]
    cfg = dataclasses.replace(get_config(arch), attn_impl="pallas")
    assert all(getattr(cfg, k) == v for k, v in widths.items()), (arch, widths)
    params = model_params(cfg, dev, seed, n_params)
    rng = np.random.default_rng(seed)
    lengths = moe_lengths(rng) if cfg.moe.enabled else served_lengths(rng)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lengths]

    with torch.inference_mode():  # warm-up: cuBLAS handles, allocator, the kernel's library
        warm = ServeEngine(params, cfg, max_batch=1, cache_len=256)
        warm.submit(Request(prompt=prompts[0][:100], max_new_tokens=2))
        warm.run()
        del warm

    engine = ServeEngine(params, cfg, max_batch=SERVE_BATCH, cache_len=SERVE_CACHE)
    reqs = [Request(prompt=p, max_new_tokens=SERVE_TOKENS) for p in prompts]
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_count.reset()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_count.snapshot()["flash_attention"]
    by_instance = launch_count.by("flash_attention", "instance")
    norm_launches = counted("rms_norm", "gated_rms_norm")
    peak = torch.cuda.max_memory_allocated()

    st = engine.stats
    assert len(done) == SERVE_REQUESTS and all(r.done for r in reqs)
    for r in reqs:
        assert len(r.generated) == SERVE_TOKENS, (r.rid, len(r.generated))
        assert all(0 <= t < cfg.vocab for t in r.generated), r.rid
    assert st["prefills"] == SERVE_REQUESTS
    assert launches == sites * st["prefills"], (launches, sites, st["prefills"])
    # prefill and decode keep the plain norm
    assert norm_launches == {"rms_norm": 0, "gated_rms_norm": 0}, norm_launches
    assert by_instance == ({instance: launches} if instance else {}), (by_instance, instance)
    prefill_tps = st["prefill_tokens"] / st["prefill_s"]
    decode_tps = st["decode_tokens"] / st["decode_s"]
    step_ms = st["decode_s"] / st["decode_steps"] * 1e3
    say(f"[families] {arch}: {SERVE_REQUESTS} requests, prompt lengths {lengths}, {SERVE_TOKENS} "
        f"tokens each, max_batch {SERVE_BATCH}, cache_len {SERVE_CACHE}: wall {wall:.3f} s; "
        f"flash_attention launches {launches} = {sites} x {st['prefills']} prefills, by instance "
        f"{by_instance}; rms_norm launches 0; peak card memory {peak / 1e9:.2f} GB")
    say(f"[families] {arch}: prefill {st['prefill_tokens']} tokens in {st['prefill_s']:.3f} s = "
        f"{prefill_tps:.1f} tok/s; decode {st['decode_tokens']} tokens in {st['decode_steps']} steps, "
        f"{st['decode_s']:.3f} s = {decode_tps:.1f} tok/s ({step_ms:.2f} ms per step)")
    out = {"launches": launches, "by_instance": by_instance, "wall_s": wall, "prefill_tps": prefill_tps,
           "decode_tps": decode_tps, "step_ms": step_ms, "peak": peak}

    if sites:  # K3 at each served prompt's shape beside SDPA's, per launch
        kh, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim
        gen = torch.Generator(dev).manual_seed(seed)
        at = [k3_at(gen, dev, kh, g, n, n, hd, True) for n in lengths]
        assert all(a["instance"] == instance for a in at), at
        kernel_s = sum(sites * a["ms"] for a in at) / 1e3
        out.update(k3_ms=sum(a["ms"] for a in at) / len(at), k3_sdpa_ms=sum(a["sdpa_ms"] for a in at) / len(at),
                   k3_err=max(a["err"] for a in at), k3_s=kernel_s)
        bounds = [in_ms(attention_bound(kh * g, kh, n, n, hd, 2, True)) for n in lengths]
        say(f"[families] {arch}: K3 ({instance}, head dim {hd}) / scaled_dot_product_attention ms "
            "(bound ms by) at each served length: "
            + "; ".join(f"{n}: {a['ms']:.4f} / {a['sdpa_ms']:.4f} ({b:.5f} by {by})"
                        for n, a, (b, by) in zip(lengths, at, bounds))
            + f"; max |kernel - plain| {out['k3_err']:.3g}; kernel time {kernel_s * 1e3:.3f} ms = "
            f"{100 * kernel_s / st['prefill_s']:.2f} % of the prefill time")

    with torch.inference_mode():
        tokens = torch.tensor(prompts[0], device=dev)[None]
        out.update(first_token_checks(params, cfg, tokens, sites, check_decode))
        batch = init_cache(cfg, SERVE_BATCH, SERVE_CACHE, device=dev)
        batch["pos"] = torch.tensor(lengths[:SERVE_BATCH], dtype=torch.int32, device=dev)
        step_tokens = torch.tensor([[int(p[-1])] for p in prompts[:SERVE_BATCH]], device=dev)
        out["profile"] = profile_decode(f"{arch} at batch {SERVE_BATCH}",
                                        lambda: decode_step(params, cfg, step_tokens, batch))
    del engine, params, batch
    torch.cuda.empty_cache()
    return out


def serve_whisper(dev, seed: int) -> dict:
    """whisper-tiny at full width through prefill/decode_step: the encoder over
    1500 frames, batch-4 prompts of 64 to 448 tokens, 16 greedy tokens each."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, prefill

    cfg = dataclasses.replace(get_config("whisper-tiny"), attn_impl="pallas")
    assert all(getattr(cfg, k) == v for k, v in WHISPER_WIDTHS.items()), cfg
    params = model_params(cfg, dev, seed, 41_197_824)
    gen = torch.Generator(dev).manual_seed(seed)
    frames = torch.randn((WHISPER_BATCH, WHISPER_FRAMES, cfg.d_model), generator=gen, device=dev)
    rng = np.random.default_rng(seed)
    lengths = [int(n) for n in rng.integers(WHISPER_PROMPTS[0], WHISPER_PROMPTS[1] + 1, WHISPER_PREFILLS)]
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab, (WHISPER_BATCH, n)).astype(np.int32)).to(dev)
               for n in lengths]

    def generate(tokens):
        cache = init_cache(cfg, WHISPER_BATCH, tokens.shape[1] + SERVE_TOKENS,
                           enc_len=WHISPER_FRAMES, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, tokens, cache, enc_frames=frames)
        nxt = logits[:, :cfg.vocab].argmax(-1)[:, None]
        out = [nxt.cpu()]  # waits for the card
        t1 = time.perf_counter()
        for _ in range(SERVE_TOKENS - 1):
            logits, cache = decode_step(params, cfg, nxt, cache)
            nxt = logits[:, :cfg.vocab].argmax(-1)[:, None]
            out.append(nxt.cpu())
        return torch.cat(out, dim=1), t1 - t0, time.perf_counter() - t1, cache

    with torch.inference_mode():
        generate(prompts[0][:, :WHISPER_PROMPTS[0]])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launch_count.reset()
        t_prefill = t_decode = 0.0
        for tokens in prompts:
            gen_tokens, tp_, td_, cache = generate(tokens)
            t_prefill, t_decode = t_prefill + tp_, t_decode + td_
            assert gen_tokens.shape == (WHISPER_BATCH, SERVE_TOKENS)
            assert int(gen_tokens.min()) >= 0 and int(gen_tokens.max()) < cfg.vocab
        launches = launch_count.snapshot()["flash_attention"]
        by_instance = launch_count.by("flash_attention", "instance")
        peak = torch.cuda.max_memory_allocated()
        per_prefill = cfg.encoder_layers + 2 * cfg.n_layers  # encoder, self, cross
        assert launches == per_prefill * WHISPER_PREFILLS, launches
        assert by_instance == {"wgmma": launches}, by_instance
        n_prefill = WHISPER_BATCH * sum(lengths)
        n_decode = WHISPER_BATCH * (SERVE_TOKENS - 1) * WHISPER_PREFILLS
        step_ms = t_decode / ((SERVE_TOKENS - 1) * WHISPER_PREFILLS) * 1e3
        say(f"[families] whisper-tiny: {WHISPER_PREFILLS} prefills of batch {WHISPER_BATCH} x "
            f"{lengths} tokens over {WHISPER_FRAMES} encoder frames, {SERVE_TOKENS} greedy tokens "
            f"each: flash_attention launches {launches} = ({cfg.encoder_layers} encoder + "
            f"{cfg.n_layers} self + {cfg.n_layers} cross) x {WHISPER_PREFILLS}, by instance "
            f"{by_instance}; peak card memory {peak / 1e9:.2f} GB")
        say(f"[families] whisper-tiny: prefill (encoder included) {n_prefill} tokens in "
            f"{t_prefill:.3f} s = {n_prefill / t_prefill:.1f} tok/s; decode {n_decode} tokens in "
            f"{t_decode:.3f} s = {n_decode / t_decode:.1f} tok/s ({step_ms:.2f} ms per step)")

        checks = first_token_checks(params, cfg, prompts[0], per_prefill, False,
                                    enc_frames=frames, enc_len=WHISPER_FRAMES)
        tokens = prompts[0]
        cache = init_cache(cfg, WHISPER_BATCH, lengths[0] + 2, enc_len=WHISPER_FRAMES, device=dev)
        _, cache = prefill(params, cfg, tokens, cache, enc_frames=frames)
        step_tokens = tokens[:, -1:]  # two calls: a warm-up and the profiled one
        profile = profile_decode(f"whisper-tiny at batch {WHISPER_BATCH}",
                                 lambda: decode_step(params, cfg, step_tokens, cache))

    kh, hd = cfg.n_kv_heads * WHISPER_BATCH, cfg.resolved_head_dim
    shapes = {"encoder": (WHISPER_FRAMES, WHISPER_FRAMES, False),
              **{f"self {n}": (n, n, True) for n in lengths},
              **{f"cross {n}": (n, WHISPER_FRAMES, False) for n in lengths}}
    at = {name: k3_at(gen, dev, kh, 1, sq, sk, hd, causal) for name, (sq, sk, causal) in shapes.items()}
    say(f"[families] whisper-tiny: K3 ({at['encoder']['instance']}, head dim {hd}, batch x heads "
        f"{kh}) / scaled_dot_product_attention ms: " + "; ".join(
            f"{name}: {a['ms']:.4f} / {a['sdpa_ms']:.4f}" for name, a in at.items())
        + f"; max |kernel - plain| {max(a['err'] for a in at.values()):.3g}")
    del params, cache
    torch.cuda.empty_cache()
    return {"launches": launches, "by_instance": by_instance, "prefill_tps": n_prefill / t_prefill,
            "decode_tps": n_decode / t_decode, "step_ms": step_ms, "peak": peak, **checks,
            "k3_err": max(a["err"] for a in at.values()), "profile": profile,
            "k3_ms": {name: a["ms"] for name, a in at.items()},
            "k3_sdpa_ms": {name: a["sdpa_ms"] for name, a in at.items()}}


def score_hybrid(dev, seed: int) -> dict:
    """zamba2-7b-instruct at full width, one row of HYBRID_SCORE_SEQ tokens
    scored under "pallas": the norm kernel launched at every norm of the
    score cell's path, each launch held against the plain version."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.rms_norm import ops as nops
    from repro_torch.models import init_params, train_loss

    cfg = dataclasses.replace(get_config("zamba2-7b-instruct"), attn_impl="pallas")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(dev).manual_seed(seed), device=dev)
    toks = torch.randint(1, cfg.vocab, (1, HYBRID_SCORE_SEQ + 1), generator=torch.Generator(dev).manual_seed(seed),
                         device=dev)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    held = []
    launch_count.reset()
    with torch.no_grad(), mock.patch.object(nops, "rms_norm_call", norm_checked(nops.rms_norm_call, held)):
        loss = float(train_loss(params, cfg, batch)[0])
    launches = counted("rms_norm", "gated_rms_norm")
    scans = launch_count.by("ssd_scan", "layout")
    sites = len(cfg.hybrid_sites)
    want = {"rms_norm": cfg.n_layers + 1 + 2 * sites, "gated_rms_norm": cfg.n_layers}
    say(f"[families] zamba2-7b-instruct ({cfg.n_layers} layers, {sites} shared-block sites, d_model "
        f"{cfg.d_model}) scores 1 x {HYBRID_SCORE_SEQ} tokens under pallas in "
        f"{time.perf_counter() - t0:.2f} s with its weights made: loss {loss:.6f}; rms_norm launches "
        f"{launches} = {cfg.n_layers} norm_in + 1 final_norm + {sites} x 2 shared-block norms and "
        f"{cfg.n_layers} gated; each of the {len(held)} against the plain version on its own inputs: "
        f"max {max(h['max_ulps'] for h in held):.0f} ulp on a unit scale, at most "
        f"{max(h['differ'] for h in held):.3g} of a launch's elements differ; ssd_scan launches "
        f"by layout of x {scans}")
    assert np.isfinite(loss), loss
    assert launches == want == {"rms_norm": 108, "gated_rms_norm": 81}, (launches, want)
    assert scans == {"bshp": cfg.n_layers} == {"bshp": 81}, scans  # no scan copies x or y
    assert len(held) == sum(want.values()), len(held)
    del params, toks, batch
    torch.cuda.empty_cache()
    return {"norm_launches": sum(launches.values()), "norm_err": max(h["max_abs_err"] for h in held),
            "loss": loss}


def families_phase(dev, seed: int) -> dict:
    """Phase 8: zamba2-7b, granite-moe-3b-a800m and mamba2-370m behind
    ServeEngine, whisper-tiny through prefill/decode_step, all at full width;
    then zamba2-7b-instruct's scoring pass (:func:`score_hybrid`)."""
    t0 = time.perf_counter()
    out = {arch: serve_family(dev, seed, arch) for arch in FAMILY_MODELS}
    out["whisper-tiny"] = serve_whisper(dev, seed)
    out["zamba2-7b-instruct"] = score_hybrid(dev, seed)
    loaded = sorted(m for m, mod in sys.modules.items()
                    if mod is not None and m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not loaded, f"the port loaded {loaded}"
    say(f"[families] phase 8 in {time.perf_counter() - t0:.2f} s")
    return out


def distributed_phase(dev, train: dict) -> dict:
    """Phase 9: phase 6's last checkpoint restored onto a (1, 1) cuda device
    mesh as DTensors and scored through the kernel; make_rules on stand-in
    pod meshes; benchmarks/run_torch.py on the card."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.distributed import (AbstractMesh, PartitionSpec, logical_to_spec, make_rules,
                                         named_shardings, zero_shard_tree)
    from repro_torch.kernels.causal_conv import ops as cops
    from repro_torch.kernels.rms_norm import ops as nops
    from repro_torch.models import abstract_params, logical_axes, train_loss
    from repro_torch.training.optimizer import OptState
    from repro_torch.tree import leaf_groups, tree_map

    t0 = time.perf_counter()
    cfg = train["cfg"]
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        rules = make_rules(cfg, mesh)
        abstract = abstract_params(cfg).tree()
        pspecs = logical_to_spec(logical_axes(cfg), rules)
        zspecs = zero_shard_tree(pspecs, abstract, mesh, axis="data")
        shardings = named_shardings({"params": pspecs,
                                     "opt": OptState(zspecs, zspecs, zspecs, PartitionSpec())}, mesh)
        template = {"params": abstract, "opt": OptState(abstract, abstract, abstract, None)}
        mgr = CheckpointManager(train["fdb"], train["run"], async_mode=False)
        step, state = mgr.restore(template, shardings=shardings)
        torch.cuda.synchronize()
        restore_s = mgr.timings[-1]["restore_s"]
        mgr.close()
        groups = leaf_groups(state)
        leaves = [t for _, group, _ in groups for t in group]
        wrong = [name for name, group, _ in groups
                 if not all(isinstance(t, DTensor) and t.device_mesh == mesh for t in group)]
        assert not wrong, f"not DTensors on the mesh: {wrong[:5]}"
        sums = checksums(tree_map(lambda t: t.full_tensor(), state))
        assert sums == train["saved"], "restored state != the state phase 6 saved"
        say(f"[dist] restored step {step} of phase 6 ({cfg.name}, {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}) onto mesh {tuple(mesh.shape)} {mesh.mesh_dim_names}: {len(groups)} "
            f"checkpoint leaves, {len(leaves)} DTensors (layer lists split), placements "
            f"{sorted({str(t.placements) for t in leaves})}, every float64 checksum equal to the "
            f"saved state's; restore {restore_s:.3f} s (phase 6's restore onto one card "
            f"{train['restore_s']:.3f} s)")

        params = abstract_params(cfg).to_empty(device=dev)
        params.copy_from(tree_map(lambda t: t.to_local(), state["params"]))
        del state, leaves
        kernel_cfg = dataclasses.replace(cfg, attn_impl="pallas")
        conv_err, norm_held = [], []
        with torch.no_grad(), mock.patch.object(
                cops, "causal_conv1d_call",
                bit_checked(cops.causal_conv1d_call, cops.ref.causal_conv1d, conv_err)), \
                mock.patch.object(nops, "rms_norm_call", norm_checked(nops.rms_norm_call, norm_held)):
            launch_count.reset()
            loss = float(train_loss(params, kernel_cfg, train["batch"])[0])
            launches, conv_launches = counted("ssd_scan", "causal_conv1d").values()
            by_instance = launch_count.by("ssd_scan", "instance")
            by_layout = launch_count.by("ssd_scan", "layout")
            norm_launches = counted("rms_norm", "gated_rms_norm")
        say(f"[dist] held-out batch scored from the restored parameters (to_local): loss {loss:.6f}, "
            f"phase 6's through the kernel {train['kernel_loss']:.6f}, |diff| "
            f"{abs(loss - train['kernel_loss']):.3g} (tolerance {RESTORED_SCORE_TOL}); ssd_scan "
            f"launches {launches}, by instance {by_instance}, by layout {by_layout}; causal_conv1d launches "
            f"{conv_launches}, each bit-equal to the plain version on its inputs; rms_norm launches "
            f"{norm_launches}, each within {max(h['max_ulps'] for h in norm_held):.0f} ulp of the "
            "plain version on its inputs")
        assert by_instance == {"split": cfg.n_layers}, by_instance
        assert by_layout == {"bshp": cfg.n_layers}, by_layout
        assert launches == cfg.n_layers, launches
        assert conv_launches == len(conv_err) == 3 * cfg.n_layers, (conv_launches, len(conv_err))
        assert norm_launches == {"rms_norm": cfg.n_layers + 1, "gated_rms_norm": cfg.n_layers}, \
            norm_launches
        assert len(norm_held) == 2 * cfg.n_layers + 1, len(norm_held)
        assert abs(loss - train["kernel_loss"]) <= RESTORED_SCORE_TOL, (loss, train["kernel_loss"])
        del params
        torch.cuda.empty_cache()

        for arch in DIST_RULES_MODELS:
            mcfg = get_config(arch)
            for shape, names in DIST_MESHES.items():
                stand_in = AbstractMesh(shape, names)
                r = make_rules(mcfg, stand_in, batch_axes=tuple(a for a in ("pod", "data") if a in names))
                sharded = {k: v for k, v in sorted(r.rules.items()) if v is not None}
                say(f"[dist] make_rules {arch} on a stand-in {shape} {names} mesh: {sharded}")
    finally:
        dist.destroy_process_group()

    t1 = time.perf_counter()
    out = subprocess.run([sys.executable, "-X", "importtime", "benchmarks/run_torch.py"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    harness_s = time.perf_counter() - t1
    assert out.returncode == 0, out.stderr[-4000:]
    imported = {line.rsplit("|", 1)[1].strip() for line in out.stderr.splitlines()
                if line.startswith("import time:") and "|" in line}
    loaded = sorted(m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not loaded, f"benchmarks/run_torch.py loaded {loaded}"
    rows = [line.split(",", 2) for line in out.stdout.splitlines()[1:] if line.count(",") >= 2]
    names = [r[0] for r in rows]
    expected = [n for line in RUN_LINES for n in (line, *RUN_KERNEL_LINES.get(line, ())[:1])]
    assert names == expected, (names, expected)
    say(f"[dist] benchmarks/run_torch.py on the card in {harness_s:.2f} s, {len(imported)} modules "
        f"imported, none of jax, jaxlib or repro:\n" + "\n".join(",".join(r) for r in rows))
    by_name = {r[0]: r for r in rows}
    harness = {}
    for plain_name, (name, kname, instance) in RUN_KERNEL_LINES.items():
        derived = dict(kv.split("=", 1) for kv in by_name[name][2].split() if "=" in kv)
        assert derived["instance"] == instance, (name, derived)
        harness[kname] = {"launches": int(derived["launches"]),
                          "max_abs_err": float(derived["max_abs_err"]),
                          "us": float(by_name[name][1]), "plain_us": float(by_name[plain_name][1])}
    # run_torch.py held each kernel line against its plain line's output at
    # tests/test_kernels.py's float32 tolerance (K1 exact) before printing it
    assert harness["grib_pack"]["max_abs_err"] == 0.0, harness
    seconds = time.perf_counter() - t0
    say(f"[dist] phase 9 in {seconds:.2f} s (restore {restore_s:.2f} s, run_torch.py {harness_s:.2f} s)")
    return {"launches": launches, "conv_launches": conv_launches, "conv_err": max(conv_err),
            "norm_launches": sum(norm_launches.values()),
            "norm_err": max(h["max_abs_err"] for h in norm_held), "restore_s": restore_s, "loss": loss,
            "harness": harness, "seconds": seconds}


def dry_cell(cell: tuple, out_dir: str) -> dict:
    """One dry-run cell on its fake production mesh (a spawned worker)."""
    from repro_torch.launch.dryrun import run_cell

    arch, shape, multi_pod, attn_impl = cell
    t0 = time.perf_counter()
    rec = run_cell(arch, shape, multi_pod, out_dir, attn_impl)
    return {**rec, "wall_s": time.perf_counter() - t0}


def dry_built(arch: str, shape: tuple, attn_impl: str) -> dict:
    """A built step of phase 10 (b) traced on a fake (1, 1) mesh (a spawned
    worker): its per-device counts and roofline terms, one card."""
    import dataclasses

    from repro_torch.configs import ShapeConfig, TrainConfig, get_config
    from repro_torch.distributed import AbstractMesh
    from repro_torch.launch.dryrun import fake_mesh, trace_cell
    from repro_torch.roofline import model_flops_for, roofline

    cfg = dataclasses.replace(get_config(arch), attn_impl=attn_impl)
    sc = ShapeConfig(*shape)
    with fake_mesh(AbstractMesh((1, 1), ("data", "model"))) as mesh:
        c = trace_cell(cfg, mesh, sc, hp=TrainConfig() if sc.kind == "train" else None)
    rep = roofline(arch=arch, shape=sc.name, mesh="1x1", chips=1,
                   cost={"flops": c["flops"], "bytes accessed": c["bytes"]},
                   collectives={"total_bytes": c["coll_total"]}, model_flops=model_flops_for(cfg, sc))
    return {**c, "roofline": rep.as_dict()}


def step_ms(fn, before=None) -> list[float]:
    """CUDA-event times of STEP_RUNS calls of ``fn`` after one warm-up call;
    ``before`` runs ahead of each call, outside the timed span."""
    times = []
    for i in range(STEP_RUNS + 1):
        if before is not None:
            before()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        if i:
            times.append(a.elapsed_time(b))
    return times


def launch_phase(dev, seed: int, smi: str) -> dict:
    """Phase 10: the dry run of phase 10's cells on fake production meshes,
    then the built steps at full width on a one-rank NCCL (1, 1) mesh beside
    their own dry-run records."""
    import dataclasses
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    import torch.distributed as dist

    from repro_torch.configs import SHAPES, ShapeConfig, get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.launch import (build_decode, build_prefill, build_train_step, make_debug_mesh,
                                    shard_args)
    from repro_torch.launch.dryrun import _skip_reason
    from repro_torch.models import decode_step, init_cache, init_params, prefill, train_loss
    from repro_torch.roofline import model_flops_for
    from repro_torch.training.optimizer import init_opt_state
    from roofline_table_torch import render_table

    t0 = time.perf_counter()
    built = (BUILT_PREFILL, BUILT_DECODE, BUILT_TRAIN, BUILT_MOE_PREFILL, BUILT_LONG_DECODE)
    with tempfile.TemporaryDirectory() as out_dir, ProcessPoolExecutor(
            max_workers=min(len(LAUNCH_CELLS) + len(built), max(1, (os.cpu_count() or 2) - 1)),
            mp_context=get_context("spawn")) as pool:
        cells = [pool.submit(dry_cell, cell, out_dir) for cell in LAUNCH_CELLS]
        debug = [pool.submit(dry_built, *b) for b in built]
        recs = [f.result() for f in cells]
        debug = [f.result() for f in debug]
    dry_s = time.perf_counter() - t0
    for cell, rec in zip(LAUNCH_CELLS, recs):
        arch, shape, _, attn_impl = cell
        cfg = dataclasses.replace(get_config(arch), attn_impl=attn_impl or "naive")
        if _skip_reason(cfg, SHAPES[shape]):
            assert rec["status"] == "skipped", rec
            say(f"[launch] {rec['cell']}: skipped ({rec['reason']})")
            continue
        assert rec["status"] == "ok", rec
        rl = rec["roofline"]
        assert rl["model_flops"] == model_flops_for(cfg, SHAPES[shape]), rec["cell"]
        assert rl["collective_bytes"] > 0 and sum(rec["collectives_raw_scanned"]["counts"].values())
        if attn_impl == "pallas":
            assert rec["ops"] == {"repro_torch::flash_attention": cfg.n_layers}, rec["ops"]
        say(f"[launch] {rec['cell']} on {rec['chips']} fake devices: traced in {rec['lower_s']} s "
            f"({rec['wall_s']:.1f} s with the probes); per device flops {rl['hlo_flops']:.4g}, bytes "
            f"{rl['hlo_bytes']:.4g}, collective bytes {rl['collective_bytes']:.4g} "
            f"{rec['collectives_raw_scanned']['counts']}; compute_s {rl['compute_s']:.4g}, memory_s "
            f"{rl['memory_s']:.4g}, collective_s {rl['collective_s']:.4g}: {rl['bottleneck']}-bound; "
            f"model_flops {rl['model_flops']:.4g}, useful {rl['useful_ratio']:.3f}; peak "
            f"{rec['memory']['peak_bytes'] / 1e9:.3f} GB a device; operators {rec['ops']}")
    for mesh_name in ("pod16x16", "pod2x16x16"):
        say(f"[launch] roofline_table_torch.render_table, mesh {mesh_name}:\n"
            + render_table(recs, mesh_name))
    say(f"[launch] dry runs in {dry_s:.1f} s (one spawned process a cell, in parallel)")

    torch.cuda.set_device(dev)
    mesh = make_debug_mesh()  # a one-rank NCCL group and a (1, 1) cuda mesh
    steps = {}
    try:
        # ---- qwen2.5-3b prefill, through K3
        arch, shape, impl = BUILT_PREFILL
        cfg = dataclasses.replace(get_config(arch), attn_impl=impl)
        sc = ShapeConfig(*shape)
        params = init_params(cfg, torch.Generator(dev).manual_seed(seed), device=dev)
        rng = np.random.default_rng(seed)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (sc.global_batch, sc.seq_len))).to(dev)
        fn, *_ = build_prefill(cfg, mesh, sc)
        cache = init_cache(cfg, sc.global_batch, sc.seq_len, device=dev)
        errs: list = []
        launch_k3 = fops.flash_attention_call

        def held(q, k, v, *, groups, causal, q_offset=0, scale=None):
            out = launch_k3(q, k, v, groups=groups, causal=causal, q_offset=q_offset, scale=scale)
            n, s = CHECK_ROWS, q.shape[1]
            for rows, keys, off in ((slice(0, n), slice(0, n), 0), (slice(s - n, s), slice(0, s), s - n)):
                ref = flash_attention_ref(q[:, rows], k[:, keys], v[:, keys], groups=groups,
                                          causal=causal, q_offset=off, scale=scale)
                torch.testing.assert_close(out[:, rows].float(), ref.float(), **ATTN_TOL[q.dtype])
                errs.append(float((out[:, rows].float() - ref.float()).abs().max()))
            return out

        launch_count.reset()
        with mock.patch.object(fops, "flash_attention_call", held):
            logits, _ = fn(params, tokens, cache)
        launches = launch_count.snapshot()["flash_attention"]
        by_instance = launch_count.by("flash_attention", "instance")
        assert launches == cfg.n_layers and by_instance == {"wgmma": cfg.n_layers}, (launches, by_instance)
        direct, _ = prefill(params, cfg, tokens, init_cache(cfg, sc.global_batch, sc.seq_len, device=dev))
        assert torch.equal(logits, direct), "the built prefill's logits != prefill()'s"
        del direct
        torch.cuda.reset_peak_memory_stats(dev)
        ms = step_ms(lambda: fn(params, tokens, cache))
        steps["prefill"] = {"ms": ms, "peak": torch.cuda.max_memory_allocated(dev)}
        say(f"[launch] built prefill {arch} {sc}: {launches} K3 launches, by instance {by_instance}, "
            f"each held against the plain version on its first and last {CHECK_ROWS} query rows of "
            f"every head: max |diff| {max(errs):.3g} (tolerance {ATTN_TOL[torch.bfloat16]}); logits "
            f"bit-equal to prefill() on the same inputs")
        del params, cache, logits, tokens
        torch.cuda.empty_cache()

        # ---- qwen2.5-3b decode over a full cache
        arch, shape, impl = BUILT_DECODE
        cfg = dataclasses.replace(get_config(arch), attn_impl=impl)
        sc = ShapeConfig(*shape)
        params = init_params(cfg, torch.Generator(dev).manual_seed(seed), device=dev)
        fn, *_ = build_decode(cfg, mesh, sc)
        cache = init_cache(cfg, sc.global_batch, sc.seq_len, device=dev)
        gen = torch.Generator(dev).manual_seed(seed + 1)
        for name in ("k", "v"):
            cache[name].normal_(generator=gen)
        token = torch.from_numpy(rng.integers(0, cfg.vocab, (sc.global_batch, 1))).to(dev)

        def last_slot():  # each step attends to the whole cache and writes its last entry
            cache["pos"] = torch.full((sc.global_batch,), sc.seq_len - 1, dtype=torch.int32, device=dev)

        torch.cuda.reset_peak_memory_stats(dev)
        ms = step_ms(lambda: fn(params, token, cache), before=last_slot)
        last_slot()
        logits, _ = fn(params, token, cache)
        assert bool(torch.isfinite(logits).all()) and logits.shape == (sc.global_batch, cfg.padded_vocab)
        steps["decode"] = {"ms": ms, "peak": torch.cuda.max_memory_allocated(dev)}
        del params, cache, logits
        torch.cuda.empty_cache()

        # ---- mamba2-370m train step, ZeRO-1 as TrainConfig has it
        from repro_torch.configs import TrainConfig

        arch, shape, impl = BUILT_TRAIN
        cfg = dataclasses.replace(get_config(arch), attn_impl=impl)
        sc = ShapeConfig(*shape)
        hp = TrainConfig()
        params = init_params(cfg, torch.Generator(dev).manual_seed(seed), device=dev)
        opt = init_opt_state(params.tree())
        toks = rng.integers(0, cfg.vocab, (sc.global_batch, sc.seq_len + 1))
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
                 "targets": torch.from_numpy(toks[:, 1:]).to(dev, torch.int32)}
        fn, *_ = build_train_step(cfg, hp, mesh, sc)
        with torch.no_grad():
            loss0 = float(train_loss(params, cfg, batch)[0])
        losses = []

        def train_step():
            nonlocal params, opt
            params, opt, metrics = fn(params, opt, batch)
            losses.append(metrics["loss"])

        torch.cuda.reset_peak_memory_stats(dev)
        ms = step_ms(train_step)
        losses = [float(x) for x in losses]
        assert abs(losses[0] - loss0) <= BUILT_LOSS_TOL, (losses[0], loss0)
        assert all(math.isfinite(x) for x in losses) and int(opt.step) == len(losses)
        steps["train"] = {"ms": ms, "peak": torch.cuda.max_memory_allocated(dev)}
        say(f"[launch] built train step {arch} {sc}, zero1={hp.zero1}: {len(losses)} steps, losses "
            + ", ".join(f"{x:.6f}" for x in losses) + f"; the first against train_loss on the same "
            f"weights and batch {loss0:.6f}, |diff| {abs(losses[0] - loss0):.3g} (tolerance "
            f"{BUILT_LOSS_TOL})")
        del params, opt, batch
        torch.cuda.empty_cache()

        # ---- granite-moe-3b-a800m prefill as DTensors: K3 through map_shards,
        # the moe FFN through its sharded form (one rank holds every expert)
        arch, shape, impl = BUILT_MOE_PREFILL
        cfg = dataclasses.replace(get_config(arch), attn_impl=impl)
        sc = ShapeConfig(*shape)
        params = init_params(cfg, torch.Generator(dev).manual_seed(seed), device=dev)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (sc.global_batch, sc.seq_len))).to(dev)
        fn, _, ins, _, _ = build_prefill(cfg, mesh, sc)
        args = shard_args((params, tokens, init_cache(cfg, sc.global_batch, sc.seq_len, device=dev)), ins)
        first = len(errs)
        launch_count.reset()
        with mock.patch.object(fops, "flash_attention_call", held):
            logits, _ = fn(*args)
        moe_launches = launch_count.snapshot()["flash_attention"]
        by_instance = launch_count.by("flash_attention", "instance")
        assert moe_launches == cfg.n_layers and by_instance == {"wgmma": cfg.n_layers}, \
            (moe_launches, by_instance)
        direct, _ = prefill(params, cfg, tokens, init_cache(cfg, sc.global_batch, sc.seq_len, device=dev))
        logits = logits.to_local()
        # a one-rank mesh holds every tensor whole: the same ops on the same
        # tensors as plain prefill(), so the same bits
        assert torch.equal(logits, direct), \
            f"the sharded prefill's logits != prefill()'s: max |diff| {float((logits - direct).abs().max())}"
        del direct
        torch.cuda.reset_peak_memory_stats(dev)
        ms = step_ms(lambda: fn(*args))
        steps["moe_prefill"] = {"ms": ms, "peak": torch.cuda.max_memory_allocated(dev)}
        say(f"[launch] built prefill {arch} {sc} as DTensors: {moe_launches} K3 launches, by instance "
            f"{by_instance}, each held against the plain version on its first and last {CHECK_ROWS} "
            f"query rows of every head: max |diff| {max(errs[first:]):.3g} (tolerance "
            f"{ATTN_TOL[torch.bfloat16]}); logits bit-equal to prefill() on plain tensors")
        del params, args, logits, tokens
        torch.cuda.empty_cache()

        # ---- zamba2-7b decode of one row over a long cache, as DTensors
        arch, shape, impl = BUILT_LONG_DECODE
        cfg = dataclasses.replace(get_config(arch), attn_impl=impl)
        sc = ShapeConfig(*shape)
        params = init_params(cfg, torch.Generator(dev).manual_seed(seed), device=dev)
        fn, _, ins, _, _ = build_decode(cfg, mesh, sc)
        cache = init_cache(cfg, sc.global_batch, sc.seq_len, device=dev)
        gen = torch.Generator(dev).manual_seed(seed + 2)
        for name in ("shared_k", "shared_v", "conv", "ssm"):
            cache[name].normal_(generator=gen)
        cache["pos"].fill_(sc.seq_len - 1)  # each step attends to the whole cache
        token = torch.from_numpy(rng.integers(0, cfg.vocab, (sc.global_batch, 1))).to(dev)
        # the DTensors hold the plain tensors' storage: one copy of the cache
        dparams, dtoken, dcache = shard_args((params, token, cache), ins)
        assert dcache["shared_k"].to_local().data_ptr() == cache["shared_k"].data_ptr()
        state = {name: cache[name].clone() for name in ("conv", "ssm")}
        want, _ = decode_step(params, cfg, token, dict(cache))
        for name, saved in state.items():  # the plain step replaced the recurrent state in place
            cache[name].copy_(saved)
        got, _ = fn(dparams, dtoken, dcache)
        got = got.to_local()
        assert torch.equal(got, want), \
            f"the sharded decode's logits != decode_step()'s: max |diff| {float((got - want).abs().max())}"
        pos = dcache["pos"]

        def rewind():  # the same position every step; the recurrent state runs on
            dcache["pos"] = pos

        torch.cuda.reset_peak_memory_stats(dev)
        ms = step_ms(lambda: fn(dparams, dtoken, dcache), before=rewind)
        steps["long_decode"] = {"ms": ms, "peak": torch.cuda.max_memory_allocated(dev)}
        say(f"[launch] built decode {arch} {sc} as DTensors: one row over {sc.seq_len} cache entries "
            f"({sum(cache[n].numel() * cache[n].element_size() for n in cache) / 1e9:.2f} GB of cache), "
            f"logits bit-equal to decode_step() on plain tensors")
        del params, dparams, cache, dcache, got, want, state
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    for (key, (arch, shape, _)), rec in zip((("prefill", BUILT_PREFILL), ("decode", BUILT_DECODE),
                                             ("train", BUILT_TRAIN), ("moe_prefill", BUILT_MOE_PREFILL),
                                             ("long_decode", BUILT_LONG_DECODE)), debug):
        st, rl = steps[key], rec["roofline"]
        step_s = statistics.median(st["ms"]) / 1e3
        st.update(step_s=step_s, mfu=rl["model_flops"] / (step_s * HW["peak_flops"]),
                  bound_s=max(rl["compute_s"], rl["memory_s"]), dry=rec)
        say(f"[launch] built {key} {arch} {shape} on the (1, 1) mesh ({smi}): "
            f"{', '.join(f'{t:.2f}' for t in st['ms'])} ms (CUDA events, {STEP_RUNS} runs after a "
            f"warm-up), median {step_s:.4f} s; dry run on a fake (1, 1) mesh: flops {rl['hlo_flops']:.4g}, "
            f"bytes {rl['hlo_bytes']:.4g}, compute_s {rl['compute_s']:.4g}, memory_s "
            f"{rl['memory_s']:.4g}, {rl['bottleneck']}-bound, bound {st['bound_s'] / step_s:.3f} of "
            f"the step; model_flops {rl['model_flops']:.4g}, mfu {st['mfu']:.4f}; peak memory "
            f"estimated {rec['memory']['peak_bytes'] / 1e9:.3f} GB, measured "
            f"{st['peak'] / 1e9:.3f} GB (torch.cuda.max_memory_allocated)")
    seconds = time.perf_counter() - t0
    say(f"[launch] phase 10 in {seconds:.2f} s (dry runs {dry_s:.2f} s)")
    return {"launches": launches, "moe_launches": moe_launches, "k3_err": max(errs), "steps": steps,
            "seconds": seconds}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.core import Key
    from repro_torch.kernels import _build
    from repro_torch.kernels.causal_conv import kernel as ck
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.grib_pack import kernel as gk
    from repro_torch.kernels.grib_pack import ops as gops
    from repro_torch.kernels.grib_pack.ref import field_stats, pack_ref, unpack_ref
    from repro_torch.kernels.rms_norm import kernel as nk
    from repro_torch.kernels.ssd_scan import kernel as sk

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # float32 matmuls and convolutions in full float32, not TF32, for every
    # comparison with a plain version
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)

    # ---------------------------------------------------------------- 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(f"[card] {smi}")
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}"
        f" devices {torch.cuda.device_count()} memory rate used for bounds {HBM_RATE / 1e12:.2f} TB/s")
    t0 = time.perf_counter()
    libraries = [gk.LIBRARY, fk.LIBRARY, sk.LIBRARY, ck.LIBRARY, nk.LIBRARY]
    libs = _build.build_all(libraries)  # one nvcc per source, all at once
    say(f"[build] {', '.join(p.name for p in libs)} in {time.perf_counter() - t0:.2f} s")
    for lib in libraries:  # ptxas's warnings and performance notes, not its -v lines
        said = "\n".join(line for line in lib.build_log.splitlines()
                         if "(C75" in line or ("ptxas info" not in line and "bytes stack frame" not in line))
        if said:
            say(f"[build] {lib.name}: nvcc said\n{said}")
    k4 = sk.LIBRARY.load()
    for kname, smem in (("ssd_chunk_state", k4.ssd_chunk_state_smem), ("ssd_chunk_scan", k4.ssd_chunk_scan_smem)):
        k4_ptxas = ptxas_lines(sk.LIBRARY.build_log, kname)
        assert len(k4_ptxas) == 2, (kname, k4_ptxas.keys())
        for mangled, said in k4_ptxas.items():
            n = 128 if "ILi128E" in mangled else 64
            say(f"[build] {kname}<{n}> (ptxas -v): {said}; {smem(n)} bytes of dynamic shared memory")
    norm_ptxas = ptxas_lines(nk.LIBRARY.build_log, "rms_norm_kernel")
    assert len(norm_ptxas) == 4, norm_ptxas.keys()  # float32 and bf16, with and without the gate
    for mangled, said in norm_ptxas.items():
        dtype = "bf16" if "nv_bfloat16" in mangled else "float32"
        say(f"[build] rms_norm_kernel<{dtype}, gate {'Lb1' in mangled}> (ptxas -v): {said}")

    # ------------------------------------------------------------- 2. kernels
    t0 = time.perf_counter()
    x = make_fields(F, H, W, args.seed, dev)
    torch.cuda.synchronize()
    n = x.numel()
    say(f"[kernels] inputs {tuple(x.shape)} float32 made on the card in {time.perf_counter() - t0:.2f} s")
    x_cpu = x.cpu()
    max_err = {"grib_pack": 0.0, "grib_unpack": 0.0}
    for nbits in NBITS:
        codes, ref, scale = gops.grib_pack(x, nbits=nbits)
        lo, sc, inv = field_stats(x, nbits)
        plain_codes = pack_ref(x, lo, inv, nbits)
        out = gops.grib_unpack(codes, ref, scale)
        plain_out = unpack_ref(codes, ref, scale)
        torch.cuda.synchronize()
        c_lo, c_sc, c_inv = field_stats(x_cpu, nbits)
        assert torch.equal(bits(ref), bits(lo)) and torch.equal(bits(scale), bits(sc)), nbits
        assert torch.equal(bits(lo).cpu(), bits(c_lo)), f"ref on the card != CPU at nbits={nbits}"
        assert torch.equal(bits(sc).cpu(), bits(c_sc)), f"scale on the card != CPU at nbits={nbits}"
        assert torch.equal(bits(inv).cpu(), bits(c_inv)), f"inv_scale on the card != CPU at nbits={nbits}"
        pack_err = float((codes.long() - plain_codes.long()).abs().max())
        unpack_err = float((out - plain_out).abs().max())
        assert torch.equal(codes, plain_codes), f"pack kernel != plain at nbits={nbits} (max {pack_err})"
        assert torch.equal(bits(out), bits(plain_out)), f"unpack kernel != plain (max {unpack_err})"
        max_err["grib_pack"] = max(max_err["grib_pack"], pack_err)
        max_err["grib_unpack"] = max(max_err["grib_unpack"], unpack_err)
        ok, frac = within_quantum(x, out, nbits)
        assert ok, f"round trip outside quantum*1.01 + 2 ulp at nbits={nbits} ({frac:.3f} of bound)"
        pk = device_ms(lambda: gk.grib_pack_call(x, ref, inv, nbits=nbits))
        pp = device_ms(lambda: pack_ref(x, lo, inv, nbits))
        uk = device_ms(lambda: gk.grib_unpack_call(codes, ref, scale))
        up = device_ms(lambda: unpack_ref(codes, ref, scale))
        nbytes = 8 * n + 8 * F
        bound = nbytes / HBM_RATE * 1e3
        say(f"[kernels] nbits={nbits} exact vs plain, round trip {frac:.3f} of its bound; "
            f"pack {pk:.4f} ms ({nbytes / pk / 1e6:.0f} GB/s) plain {pp:.4f} ms; "
            f"unpack {uk:.4f} ms ({nbytes / uk / 1e6:.0f} GB/s) plain {up:.4f} ms; "
            f"{nbytes / 1e9:.3f} GB moved per pass, bound {bound:.4f} ms")
        del codes, ref, scale, lo, sc, inv, plain_codes, out, plain_out
    say("[kernels] library_ms of grib_pack: none, no single PyTorch call computes GRIB simple "
        "packing (min/max, scale, round half to even, clip, cast); grib_unpack's library call "
        "is torch.addcmul(ref, codes, scale)")

    # the main path packs and unpacks one tier's slice: (16, H, W) per launch
    xs = x[:PER_MEMBER]
    ns = xs.numel()
    timing = {}
    for nbits in sorted(set(TIER_NBITS.values())):
        codes, ref, scale = gops.grib_pack(xs, nbits=nbits)
        _, _, inv = field_stats(xs, nbits)
        assert torch.equal(codes, pack_ref(xs, ref, inv, nbits))
        out = gops.grib_unpack(codes, ref, scale)
        assert torch.equal(bits(out), bits(unpack_ref(codes, ref, scale)))
        lib_err = float((library_unpack(codes, ref, scale) - out).abs().max())
        pack_call = lambda: gk.grib_pack_call(xs, ref, inv, nbits=nbits)  # noqa: E731
        unpack_call = lambda: gk.grib_unpack_call(codes, ref, scale)  # noqa: E731
        timing[nbits] = {
            "grib_pack": {"ms": device_ms(pack_call), "call_ms": call_ms(pack_call),
                          "plain_ms": device_ms(lambda: pack_ref(xs, ref, inv, nbits)),
                          "library_ms": None},
            "grib_unpack": {"ms": device_ms(unpack_call), "call_ms": call_ms(unpack_call),
                            "plain_ms": device_ms(lambda: unpack_ref(codes, ref, scale)),
                            "library_ms": device_ms(lambda: library_unpack(codes, ref, scale))},
        }
        say(f"[kernels] main-path shape {tuple(xs.shape)} nbits={nbits}: "
            + "; ".join(f"{k} {v['ms']:.4f} ms (one call from idle {v['call_ms']:.4f} ms) "
                        f"plain {v['plain_ms']:.4f} ms" for k, v in timing[nbits].items())
            + f"; library addcmul {timing[nbits]['grib_unpack']['library_ms']:.4f} ms, "
            f"max |addcmul - kernel| {lib_err:.3g}")
    del codes, ref, scale, inv, out
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 3. path
    keys = [
        Key({"class": "od", "stream": "enfo", "expver": "0001", "date": "20240101",
             "time": "0000", "type": "pf", "levtype": "pl", "number": str(m),
             "levelist": lev, "step": "0", "param": p})
        for m in range(MEMBERS)
        for p in ("t", "u", "v", "q")
        for lev in ("1000", "850", "500", "250")
    ]
    assert len(keys) == F
    eff = x.numel() * 4
    run = drive_path(x, keys, trace=False)  # the measured run: no tracer
    launches = run["launches"]
    gib = 1024 ** 3
    say(f"[path] archive_fields+flush {run['archive_s']:.3f} s = {eff / gib / run['archive_s']:.3f} GiB/s "
        f"effective; retrieve_fields+arrays {run['retrieve_s']:.3f} s = "
        f"{eff / gib / run['retrieve_s']:.3f} GiB/s effective; "
        f"effective/wire {eff / run['wire']:.4f} ({eff} / {run['wire']} B)")
    say(f"[path] kernel launches {launches}, codec counts {run['codec_counts']}")
    traced = drive_path(x, keys, trace=True)  # the same run again, traced
    say(f"[path] traced run: archive {traced['archive_s']:.3f} s, retrieve {traced['retrieve_s']:.3f} s; "
        "span seconds over the step, with counts (nested spans overlap): "
        + ", ".join(f"{k} {v[0]:.4f} ({v[1]})"
                    for k, v in sorted(traced["spans"].items(), key=lambda kv: -kv[1][0])))
    for side in ("pack", "unpack"):
        steps = {k: v for k, v in traced["spans"].items() if k.startswith(f"codec.{side}.")}
        assert steps, f"the traced run recorded no codec.{side} step spans"
        say(f"[path] codec.{side} steps over both tiers (ms): "
            + ", ".join(f"{k.rsplit('.', 1)[1]} {v[0] * 1e3:.1f}" for k, v in steps.items()))

    torch.cuda.empty_cache()

    # ----------------------------------------------------------- 4. attention
    attn = attention_phase(dev, args.seed)

    # --------------------------------------------------------------- 5. serve
    serve = serve_phase(dev, args.seed)
    torch.cuda.empty_cache()  # the serving phase's weights are gone

    # ----------------------------------------------------------------- 6. ssm
    conv = conv_phase(dev, args.seed)
    torch.cuda.empty_cache()
    norm = norm_phase(dev, args.seed)
    torch.cuda.empty_cache()
    ssd = ssd_phase(dev, args.seed)
    torch.cuda.empty_cache()
    train = train_phase(dev, args.seed)
    torch.cuda.empty_cache()

    # -------------------------------------------------------------- 7. hammer
    t0 = time.perf_counter()
    hammer = hammer_phase(dev)
    say(f"[hammer] phase 7 in {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ 8. families
    families = families_phase(dev, args.seed)
    torch.cuda.empty_cache()

    # --------------------------------------------------------- 9. distributed
    dist9 = distributed_phase(dev, train)
    del train["fdb"]  # phase 6's checkpoints, held in host memory until now

    # ------------------------------------------------------------- 10. launch
    launch = launch_phase(dev, args.seed, smi)

    loaded = sorted(m for m, mod in sys.modules.items()
                    if mod is not None and m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not loaded, f"the port loaded {loaded}"

    kernels = []
    for kname, line in (("grib_pack", 31), ("grib_unpack", 39)):
        t = timing[16][kname]
        by_path = {"path": launches[kname],
                   **{f"hammer_{io}": m["launches"][kname] for io, m in hammer["modes"].items()}}
        if kname == "grib_pack":
            by_path["run_torch.py"] = dist9["harness"]["grib_pack"]["launches"]
        assert all(by_path.values()), by_path
        nbytes = 8 * ns + 8 * PER_MEMBER
        ops = (5 if kname == "grib_pack" else 3) * ns
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "src/repro_torch/kernels/grib_pack/csrc/grib_pack.cu",
            "replaces": f"src/repro/kernels/grib_pack/kernel.py:{line}",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max_err[kname],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": max(nbytes / HBM_RATE, ops / F32_PEAK) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_RATE >= ops / F32_PEAK else "operations",
            "library_ms": t["library_ms"],
        })
    # every path that runs K3: phase 5's, then phase 8's models with attention
    k3_paths = {"serve qwen2.5-3b": serve["launches"],
                **{arch: f["launches"] for arch, f in families.items() if "k3_err" in f},
                "run_torch.py": dist9["harness"]["flash_attention"]["launches"],
                "launch prefill_8k (phase 10)": launch["launches"],
                "launch granite prefill_4k as DTensors (phase 10)": launch["moe_launches"]}
    assert all(k3_paths.values()), k3_paths
    kernels.append({
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:30",
        "launches": sum(k3_paths.values()),
        "launches_by_path": k3_paths,
        **{k: attn[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "instance",
                                "tflops")},
        "zamba2": {k: attn["zamba2"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms", "instance")},
        "max_abs_err": max(attn["max_abs_err"], dist9["harness"]["flash_attention"]["max_abs_err"],
                           launch["k3_err"],
                           *(f[k] for f in families.values()
                             for k in ("k3_err", "k3_model_err") if k in f)),
    })
    # every path that runs K4: phase 6's scoring, phase 9's from the restored
    # state, and run_torch.py's ssd_scan_512
    k4_paths = {"score (phase 6)": train["launches"], "score restored (phase 9)": dist9["launches"],
                "run_torch.py": dist9["harness"]["ssd_scan"]["launches"]}
    assert all(k4_paths.values()), k4_paths
    kernels.append({
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:30",
        "launches": sum(k4_paths.values()),
        "launches_by_path": k4_paths,
        "max_abs_err": max(ssd["max_abs_err"], train["layer_err"],
                           dist9["harness"]["ssd_scan"]["max_abs_err"]),
        **{k: ssd[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "instance",
                               "launch_ms", "launch_bound_ms", "chunked_ms")},
    })
    # every path that runs the causal convolution: the same two scoring passes
    conv_paths = {"score (phase 6)": train["conv_launches"],
                  "score restored (phase 9)": dist9["conv_launches"]}
    assert all(conv_paths.values()), conv_paths
    kernels.append({
        "name": "causal_conv1d",
        "route": "cuda",
        "source": "src/repro_torch/kernels/causal_conv/csrc/causal_conv.cu",
        "replaces": None,  # the reference convolves with jax.lax.conv_general_dilated
        "launches": sum(conv_paths.values()),
        "launches_by_path": conv_paths,
        "max_abs_err": max(conv["max_abs_err"], train["conv_err"], dist9["conv_err"]),
        **{k: conv[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    })
    # every path that runs the norm kernel: the same two scoring passes
    norm_paths = {"score (phase 6)": train["norm_launches"],
                  "score restored (phase 9)": dist9["norm_launches"],
                  "score zamba2-7b-instruct (phase 8)": families["zamba2-7b-instruct"]["norm_launches"]}
    assert all(norm_paths.values()), norm_paths
    gated = norm["shapes"][0]  # mamba2-370m's gated norm, the largest of the score cell
    kernels.append({
        "name": "rms_norm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rms_norm/csrc/rms_norm.cu",
        "replaces": None,  # the reference normalises with jnp (repro.models.ops.rms_norm)
        "launches": sum(norm_paths.values()),
        "launches_by_path": norm_paths,
        "max_abs_err": max(norm["max_abs_err"], train["norm_err"], dist9["norm_err"],
                           families["zamba2-7b-instruct"]["norm_err"]),
        **{k: gated[k] for k in ("ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call gates and normalises; F.rms_norm's
        # times at the shapes without the gate are under "shapes"
        "shapes": norm["shapes"],
    })
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
