// Mamba2 SSD chunked scan for Hopper (sm_90a), in two instances chosen by the
// wrapper from (dtype, P, N) alone:
//
//   1. `ssd_scan_fwd`: x, B and C in float32, or bf16 at head dims 8 and 16
//      (and at 64 with state sizes other than 64 and 128); everything in
//      float32 on the CUDA cores.
//   2. the split instance: bf16 x, B and C at P = 64, N = 64 or 128 (the
//      heads of mamba2-370m and zamba2-7b), in two launches on the tensor
//      cores (wgmma fed by TMA), with float32 operands split into bf16 terms.
//
// Both replace the Pallas TPU kernel `ssd_scan_kernel` of
// src/repro/kernels/ssd_scan/kernel.py.  Per chunk of Q rows of one
// (batch, head):
//     cum     = inclusive cumsum(dt * a)            total = cum[Q-1]
//               (float32 products added in float64, each prefix rounded once)
//     y_i     = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//             + exp(cum_i) (C_i . state^T)
//     state   = exp(total) state + sum_j exp(total - cum_j) dt_j x_j (x) B_j
//     out_i   = y_i + D x_i, cast once to x's type.
// The exponent of a pair above the diagonal is never taken (the Pallas body
// masks it to -inf before exp, which gives 0), so exp never overflows.
//
// Layout: dt (BH, S), A and D (BH,), B and C (BH/heads, S, N) shared by the
// heads of one batch entry (the Pallas index map b // heads), all contiguous.
// x and out are (BH, S, P) in ssd_scan_fwd.  The split instance reads x and
// writes out in the mixer's (B, S, H, P) layout: element (bh, s, p) of head h
// = bh % H of sequence b = bh / H lies at ((b S + s) H + h) P + p, the H heads
// of a sequence row interleaved, each row of a head 128 contiguous bytes.  H,
// the heads of a sequence row (`hrow` below), is a value of the launch, not
// of the instance: H = 1 is the flat (BH, S, P) layout.  Its TMA maps of x
// are 4-D, (P, H, S, B), so S keeps its own dimension and a box that runs
// past the end of a sequence reads zeros, never the next sequence's rows.
// The heads of one B and C row (`heads`) and H need not agree: Zamba2's
// 112 heads a row take B and C in 2 groups of 56.
//
// ---- 1. ssd_scan_fwd
// One block of 256 threads owns one (batch, head) and walks its chunks in
// order; the loop takes the place of the TPU grid's sequential "arbitrary"
// chunk axis, and the (P, N) float32 state stays in shared memory from one
// chunk to the next.  A chunk of B and C in float32 at Q = 256, N = 128 would
// be 128 KB each, so the chunk is cut into 64-row blocks: for each i block,
// C_i is staged once (transposed), and the j blocks j <= i are staged in turn
// (B_j transposed, x_j as is), as in a flash loop with a decay mask in place
// of the softmax.  A thread owns a 4 x 4 tile of the scores (rows 4ty..,
// columns tx + 16c) and 4 rows by P/16 columns of the output.  The last i
// block visits every j block, so the state update is accumulated there, in
// registers, and written after every i block has read the old state.  At
// P = 64, N = 128, Q = 256 the block holds 137 KB of dynamic shared memory,
// so one block runs on each SM.  Its work, about 34 MFLOP per (batch-head,
// chunk) against 0.1 MB moved, runs in float32 on the CUDA cores (67 TFLOP/s
// peak), each operand read from shared memory for every multiply-add.
//
// ---- 2. the split instance (ssd_chunk_state, ssd_chunk_scan)
// Only the C . state^T term and the state recurrence depend on earlier
// chunks (the SSD split of arXiv:2405.21060 section 6), so the scan runs as
//   ssd_chunk_state  grid BG x chunks x head groups: each chunk's cumsum
//                    (written to a (BH, S) float32 scratch) and its own state
//                    contribution S_c = B^T (w x), w_j = exp(total - cum_j)
//                    dt_j, for every chunk at once; then, chained from block
//                    to block in chunk order, the state entering each chunk,
//                    h_0 = 0, h_{c+1} = exp(total_c) h_c + S_c, into a (BH,
//                    chunks, N, P) float32 scratch.  S_c itself never goes to
//                    memory (but for a check output);
//   ssd_chunk_scan   grid BG x chunks x head groups x 64-row tiles: for its
//                    64 rows i, G_ij = C_i . B_j^T for each 64-row tile j <= i,
//                    once for the group's heads; then per head the masked
//                    decay exp(cum_i - cum_j) dt_j in float32 and scores . x_j,
//                    then exp(cum_i) (C_i . h_c^T) and D x_i.
// Both are built for Hopper, as below.
//
// Precision.  x, B and C are bf16 inputs and enter once.  Each operand the
// kernel derives in float32 -- the scores, w x and h -- enters as three bf16
// terms, v = t0 + t1 + t2 + r with t0 = bf16(v), t1 = bf16(v - t0), t2 =
// bf16(v - t0 - t1) and |r| <= 2^-26 |v| (each difference is exact), three
// products into the same float32 accumulator, the smallest first: float32
// operands in all but name, so the instance keeps the float32 semantics of
// ssd_scan_fwd.  Two terms (hi + lo, 2^-18) were not enough: the plain version
// with its operands rounded to hi + lo moved chip_smoke.py's held-out loss of
// trained mamba2-370m by 1.7e-3 from the float32 one.  The plain version with
// split_bf16=True rounds the same operands to t0 + t1 + t2.
//
// ---- ssd_chunk_scan on wgmma and TMA
// What bounds it.  At the full-width scoring shape (x 256 x 2048 x 64, B and C
// 8 x 2048 x 128, chunk 256, 32 heads a batch entry) the launch must read x
// (67 MB), the float32 states h (67 MB), B, C, cum and dt (13 MB) and write y
// (67 MB): 214 MB, 0.064 ms at 3.35 TB/s.  With whole 64 x 64 tiles and three
// terms its products are about 60 GFLOP, 0.061 ms at the bf16 dense peak:
// scores . x 32, C . h^T 23 and C . B^T 5.4 (43 if made for every head, as the
// mma.sync version did).  Beside them the CUDA cores make 84 M scores (an exp,
// two multiplies and three bf16 terms each) and split 59 M elements of h into
// terms.  Both bounds are near and the CUDA-core work is of the same order,
// so the design keeps the three kinds of work apart and in flight together:
//   - one block of three warpgroups per (batch entry, chunk, group of
//     HEAD_GROUP heads, 64-row tile i), the heaviest tiles first.  G_ij = C_i .
//     B_j^T is made once for the group's heads on wgmma m64n64k16 (both
//     operands K-major from TMA tiles) and kept in float32 in shared memory,
//     up to GC = 4 tiles (a chunk of 256 rows).  A longer chunk runs in windows
//     of GC tiles with one head for each consumer, G made again per window;
//   - warpgroup 0 gives its registers up (setmaxnreg) and two of its lanes
//     issue TMA loads, one for each consumer warpgroup: C_i once, B_j for the
//     consumer's share of G, then x_hj for each of its heads and j through a
//     ring of XS stages, and an L2 prefetch of each head's h;
//   - each consumer walks its heads (k, k + 2, ...).  Per j it applies the
//     head's decay to G on the accumulator's layout (cum and dt staged in
//     shared memory by cp.async a head ahead; exp on one MUFU.EX2), splits the
//     scores into three A-register words per k-step, and runs wgmma m64n64k16
//     with x_j as the MN-major B operand (the P . V pattern of
//     flash_attention.cu), making tile j + 1's scores while tile j's products
//     run.  Then it splits h_c 64 rows at a time into three swizzled bf16
//     blocks and runs C_i . h^T on wgmma with both operands in shared memory.
//     The two consumers work on different heads;
//   - no branch or register copy sits between a wgmma fence and its
//     products: ptxas can then serialise every wgmma of the kernel, each
//     waited for before the next is issued (C7513, C7520), or add fences
//     (C7519);
//   - rows past the end of a chunk that is not a multiple of 64 are masked in
//     the scores and zeroed in x_j: a TMA box fills zeros only past the end of
//     the sequence and would read the next chunk's rows;
//   - no atomics: every sum runs in a fixed order of j tiles, terms and heads,
//     so two runs give the same bits.
// Where its time goes (tools/ssd_scan_ablation.py at the full-width shape,
// medians of 3, an H100 80GB HBM3 at 700 W): 0.2507 ms as built, 0.1747 for
// scores . x alone.  Left out one at a time, C . h^T saves 0.051 ms, the
// epilogue's x read and y store 0.025, the exponential 0.019, scores . x's
// two smaller terms 0.032 and the G products 0.002.  At one j tile a block
// the launch takes 0.1822: a block costs about 0.137 ms whatever its tiles,
// and a j tile of a head about 0.046.  A design that split h on the
// producer's idle warps, handed the terms over by mbarrier and ran C . h^T
// under the next head's scores kept every bit but ran 4 % slower: the split
// took scheduler slots the consumers' warps need, and a head's split could not
// start before the last head's products had read the terms.
//
// ---- ssd_chunk_state on wgmma and TMA, the state pass chained across its blocks
// What bounds it.  At the full-width scoring shape the launch must read x
// (67.1 MB), B (4.2 MB) and dt (2.1 MB) and write cum (2.1 MB) and h (67.1
// MB): 142.6 MB, 0.0426 ms at 3.35 TB/s.  Its products, S_c^T = (w x)^T B for
// every chunk but the last, are 7.5 GFLOP, 22.5 with three terms: 0.023 ms
// at the bf16 dense peak.  So bytes bound it.  The two launches it replaces
// (mma.sync chunk states, then a pass over them) also wrote the chunk states
// S_c (58.7 MB) and read them back, and staged each tile on one cp.async
// stage, its loads never beside its products.  The design:
//   - one block of a consumer warpgroup and a producer warp per (batch entry,
//     chunk, group of STATE_GROUP = 2 heads): 8 x 8 x 16 = 1024 blocks at
//     full width, of which the 128 of the last chunk only write cum.  A block
//     takes 107.7 KB of shared memory at N 128 (a ring of GC B tiles, 64 KB,
//     loaded once for its heads; an x ring of STATE_XS tiles, 24 KB; w and a
//     cum scratch, 16 KB), so two blocks run on an SM and 264 at once: the
//     896 that make states take 3.4 rounds, and with tickets chunk outermost
//     a block's predecessor chunk has mostly finished before it waits.  Ten
//     warps an SM leave 168 registers a thread (three warps share one of the
//     SM's four register files).  On an H100 this beat one block an SM of two
//     consumer warpgroups and 8 heads (whose consumers reached their
//     epilogues in step), and 1, 4 and 8 heads a block here (the ablation
//     tool times each);
//   - lane 0 of the producer warp issues the TMA loads: each B tile once,
//     then every head's x tiles through the ring.  A consumer thread fences
//     the proxies (fence.proxy.async) between its ldmatrix reads of an x
//     stage and its arrival on the stage's empty barrier: without it the
//     next TMA write into the stage could overtake the reads, and at N 64
//     and a large grid (64 x 32 heads x 2048 rows, or Zamba2's cell) a few
//     chunks' states a launch came out wrong, in whole 16-row slices of p
//     (one warp's A rows), always of a block's first head;
//   - the consumer walks its heads.  A = (w x)^T comes from the x tile by
//     ldmatrix.trans (the scores . x pattern of ssd_chunk_scan, with x in
//     place of the scores), is scaled by w_j in float32 and split into three
//     bf16 words, the smallest term first into wgmma m64n128k16 (m64n64k16 at
//     N 64) with B_j as the MN-major B operand.  The next step's words are
//     made while a step's products run: a step is a tile at N 64 and half a
//     tile at N 128, where the 64 accumulator registers leave room for two
//     buffers of two k-steps' words, not of four (with four, ptxas spilled
//     and serialised every wgmma, C7512).  No branch or register copy sits
//     between a wgmma fence and its products.  Rows past the end of a chunk
//     that does not fill its last tile are zeroed in A (a TMA box reads on
//     into the next chunk);
//   - the cumsum keeps its float64 sums, each prefix rounded once, so cum is
//     what the plain version and ssd_scan_fwd compute;
//   - the recurrence is a chained scan.  Every block makes its S_c without
//     waiting, then, per head, waits for chunk c - 1's block to flag h_c
//     written, reads all of its h_c from L2 at once (the stores of h_{c+1}
//     would otherwise hold each load back), writes h_{c+1} = exp(total_c) h_c
//     + S_c (expf, __fmul_rn, then __fadd_rn) and flags it.  Blocks take
//     their place from an atomic ticket, chunk outermost, so a block that
//     waits has a predecessor that has started: progress does not hang on
//     the order in which blocks are run;
//   - the ticket and the flags belong to the caller's instance and are zeroed
//     on the launch's stream before it; no atomic takes part in a sum, so two
//     runs give the same bits.
// Where its time goes (H100, copies of this source with parts taken out):
// the A words, the x loads and the cumsum alone take about 0.04 ms, the
// products add about 0.025 and the chained epilogue about 0.03: the three
// run one after another more than beside each other, which is what a later
// design has to change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdio.h>

#include <atomic>
#include <type_traits>

#include "../../csrc/hopper.cuh"

namespace {

constexpr int THREADS = 256;  // 16 row groups (ty) x 16 column lanes (tx)
constexpr int TB = 64;        // rows of an i block and of a j block
constexpr int LT = TB + 4;    // row length of the transposed tiles; keeps float4 alignment
constexpr int MAX_N = 128;
constexpr int MAX_CHUNK = 2048;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

size_t smem_bytes(int p, int n, int q) {
    // ct [n][LT] + bt [n][LT] + st [TB][LT] + xs [TB][p] + state [n][p] + 4 x [q]
    return (size_t)(2 * n * LT + TB * LT + TB * p + n * p + 4 * q) * sizeof(float);
}

// Stage rows [row0, row0 + rows) of a (., n) matrix as float32, transposed to
// [n][LT]; rows at or past `rows` are zero.
template <typename T>
__device__ __forceinline__ void stage_t(float* dst, const T* __restrict__ src, size_t row0,
                                        int rows, int n) {
    for (int e = threadIdx.x; e < TB * n; e += THREADS) {
        const int r = e / n, k = e - r * n;
        dst[k * LT + r] = r < rows ? to_f32(src[(row0 + r) * n + k]) : 0.f;
    }
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
ssd_scan_fwd(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
             const T* __restrict__ bmat, const T* __restrict__ cmat,
             const float* __restrict__ dskip, T* __restrict__ y, int s, int n, int q, int heads) {
    static_assert(P % 8 == 0 && THREADS % P == 0 && P <= 64, "head dim must divide 256, at most 64");
    constexpr int PC = (P + 15) / 16;                           // output columns per thread
    constexpr int SPT = (P * MAX_N + THREADS - 1) / THREADS;    // state entries per thread
    extern __shared__ float4 smem4[];
    float* ct = reinterpret_cast<float*>(smem4);  // [n][LT]  C of the i block, transposed
    float* bt = ct + n * LT;                      // [n][LT]  B of the j block, transposed
    float* st = bt + n * LT;                      // [TB][LT] scores, transposed: st[j][i]
    float* xs = st + TB * LT;                     // [TB][P]  x of the j block
    float* state = xs + TB * P;                   // [n][P]   carried state, transposed
    float* cum = state + n * P;                   // [q]
    float* dts = cum + q;                         // [q]
    float* wts = dts + q;                         // [q]      exp(total - cum) * dt
    float* ecum = wts + q;                        // [q]      exp(cum)

    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int bh = blockIdx.x;
    const size_t row0 = (size_t)bh * s;              // first row of x, dt and y
    const size_t brow0 = (size_t)(bh / heads) * s;   // first row of B and C
    const float av = a[bh], dv = dskip[bh];
    const int nib = (q + TB - 1) / TB;
    const int sp = tid % P;  // the state column this thread updates

    for (int e = tid; e < n * P; e += THREADS) state[e] = 0.f;

    for (int c0 = 0; c0 < s; c0 += q) {
        __syncthreads();  // the previous chunk is done with every buffer; its state is written
        for (int t = tid; t < q; t += THREADS) {
            const float d = dt[row0 + c0 + t];
            dts[t] = d;
            cum[t] = __fmul_rn(d, av);
        }
        __syncthreads();
        if (tid < 32) {
            // inclusive cumsum by warp 0, accumulated in float64 and rounded
            // once per prefix, as the plain version does: its float32 values
            // then do not depend on the order of the additions (see ref.py)
            const int seg = (q + 31) / 32;
            const int lo = min(tid * seg, q), hi = min(lo + seg, q);
            double run = 0.0;
            for (int t = lo; t < hi; ++t) run += (double)cum[t];
            double incl = run;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const double v = __shfl_up_sync(0xffffffffu, incl, o);
                if (tid >= o) incl += v;
            }
            double pre = __shfl_up_sync(0xffffffffu, incl, 1);
            if (tid == 0) pre = 0.0;
            for (int t = lo; t < hi; ++t) {
                pre += (double)cum[t];
                cum[t] = __double2float_rn(pre);
            }
        }
        __syncthreads();
        const float total = cum[q - 1];
        for (int t = tid; t < q; t += THREADS) {
            wts[t] = __fmul_rn(expf(__fsub_rn(total, cum[t])), dts[t]);
            ecum[t] = expf(cum[t]);
        }

        float contrib[SPT];
#pragma unroll
        for (int k = 0; k < SPT; ++k) contrib[k] = 0.f;

        for (int ib = 0; ib < nib; ++ib) {
            const int i0 = ib * TB;
            __syncthreads();  // the previous i block is done with ct; wts and ecum are written
            stage_t(ct, cmat, brow0 + c0 + i0, min(TB, q - i0), n);
            __syncthreads();

            // inter-chunk term: C_i . state^T, from the state entering the chunk
            float inter[4][PC], acc[4][PC];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < PC; ++c) inter[r][c] = acc[r][c] = 0.f;
#pragma unroll 4
            for (int k = 0; k < n; ++k) {
                const float4 cv = *reinterpret_cast<const float4*>(&ct[k * LT + 4 * ty]);
#pragma unroll
                for (int c = 0; c < PC; ++c) {
                    const int p = tx + 16 * c;
                    if (p < P) {
                        const float sv = state[k * P + p];
                        inter[0][c] += cv.x * sv;
                        inter[1][c] += cv.y * sv;
                        inter[2][c] += cv.z * sv;
                        inter[3][c] += cv.w * sv;
                    }
                }
            }

            for (int jb = 0; jb <= ib; ++jb) {
                const int j0 = jb * TB;
                const int jrows = min(TB, q - j0);
                __syncthreads();  // the previous j block is done with bt, xs and st
                stage_t(bt, bmat, brow0 + c0 + j0, jrows, n);
                for (int e = tid; e < TB * P; e += THREADS) {
                    const int r = e / P;
                    xs[e] = r < jrows ? to_f32(x[(row0 + c0 + j0) * P + e]) : 0.f;
                }
                __syncthreads();

                // scores of rows i0 + 4ty + r against columns j0 + tx + 16c
                float sc[4][4];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
#pragma unroll 4
                for (int k = 0; k < n; ++k) {
                    const float4 cv = *reinterpret_cast<const float4*>(&ct[k * LT + 4 * ty]);
                    const float* br = &bt[k * LT + tx];
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const float bv = br[16 * c];
                        sc[0][c] += cv.x * bv;
                        sc[1][c] += cv.y * bv;
                        sc[2][c] += cv.z * bv;
                        sc[3][c] += cv.w * bv;
                    }
                }
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int j = j0 + tx + 16 * c;
                    float v[4];
#pragma unroll
                    for (int r = 0; r < 4; ++r) {
                        const int i = i0 + 4 * ty + r;
                        v[r] = 0.f;  // j > i: exp of the masked exponent is 0
                        if (j <= i && i < q) {
                            v[r] = __fmul_rn(__fmul_rn(sc[r][c], expf(__fsub_rn(cum[i], cum[j]))),
                                             dts[j]);
                        }
                    }
                    *reinterpret_cast<float4*>(&st[(tx + 16 * c) * LT + 4 * ty]) =
                        make_float4(v[0], v[1], v[2], v[3]);
                }
                __syncthreads();  // st is complete

                // intra-chunk term: scores . x
                for (int jj = 0; jj < jrows; ++jj) {
                    const float4 sv = *reinterpret_cast<const float4*>(&st[jj * LT + 4 * ty]);
#pragma unroll
                    for (int c = 0; c < PC; ++c) {
                        const int p = tx + 16 * c;
                        if (p < P) {
                            const float xv = xs[jj * P + p];
                            acc[0][c] += sv.x * xv;
                            acc[1][c] += sv.y * xv;
                            acc[2][c] += sv.z * xv;
                            acc[3][c] += sv.w * xv;
                        }
                    }
                }
                if (ib == nib - 1) {  // the last i block visits every j block: accumulate the state update
                    for (int jj = 0; jj < jrows; ++jj) {
                        const float xw = __fmul_rn(xs[jj * P + sp], wts[j0 + jj]);
#pragma unroll
                        for (int k = 0; k < SPT; ++k) {
                            const int kk = tid / P + (THREADS / P) * k;
                            if (kk < n) contrib[k] += xw * bt[kk * LT + jj];
                        }
                    }
                }
            }

            // out = (intra + exp(cum) * inter) + D * x, cast once
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = i0 + 4 * ty + r;
                if (i >= q) continue;
#pragma unroll
                for (int c = 0; c < PC; ++c) {
                    const int p = tx + 16 * c;
                    if (p < P) {
                        const size_t at = (row0 + c0 + i) * P + p;
                        const float yv = __fadd_rn(acc[r][c], __fmul_rn(ecum[i], inter[r][c]));
                        y[at] = from_f32<T>(__fadd_rn(yv, __fmul_rn(dv, to_f32(x[at]))));
                    }
                }
            }
        }

        __syncthreads();  // every i block has read the state entering this chunk
        const float et = expf(total);
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
            const int kk = tid / P + (THREADS / P) * k;
            if (kk < n) {
                float* sv = &state[kk * P + sp];
                *sv = __fadd_rn(__fmul_rn(et, *sv), contrib[k]);
            }
        }
    }
}

template <typename T, int P>
cudaError_t launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
                   const void* d, void* y, int bh, int s, int n, int q, int heads,
                   cudaStream_t stream) {
    const size_t smem = smem_bytes(P, n, q);
    auto kernel = ssd_scan_fwd<T, P>;
    // asked for once per device, for the largest state and chunk
    static std::atomic<unsigned long long> smem_devices{0};
    cudaError_t err = hopper::allow_smem(kernel, smem_bytes(P, MAX_N, MAX_CHUNK), smem_devices);
    if (err != cudaSuccess) return err;
    kernel<<<bh, THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
        static_cast<const T*>(b), static_cast<const T*>(c), static_cast<const float*>(d),
        static_cast<T*>(y), s, n, q, heads);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int p, const void* x, const void* dt, const void* a, const void* b,
                     const void* c, const void* d, void* y, int bh, int s, int n, int q,
                     int heads, cudaStream_t stream) {
    switch (p) {
        case 8:
            return launch<T, 8>(x, dt, a, b, c, d, y, bh, s, n, q, heads, stream);
        case 16:
            return launch<T, 16>(x, dt, a, b, c, d, y, bh, s, n, q, heads, stream);
        case 32:
            return launch<T, 32>(x, dt, a, b, c, d, y, bh, s, n, q, heads, stream);
        case 64:
            return launch<T, 64>(x, dt, a, b, c, d, y, bh, s, n, q, heads, stream);
        default:
            return cudaErrorInvalidValue;
    }
}


// ------------------------------------------------------------------------
// 2. the split instance
// ------------------------------------------------------------------------

namespace sp {

using bf16 = __nv_bfloat16;
using hopper::ldmatrix_x4_trans;
using hopper::pack_bf16;

constexpr int P = 64;          // head dim
constexpr int TILE = 64;       // rows of a chunk tile
constexpr int TERMS = 3;       // bf16 terms of a float32 operand

// Launch 2 (the wgmma instance of the header note): grid BG x chunks x head
// groups x tiles, flattened with the tile fastest (the tiles of one chunk
// share its B, C and h in L2) and the heaviest tile first.  Warpgroup 0 is
// the producer: lane 0 of its warp k issues every TMA load of consumer k
// (C_i by warp 0 for both).  Warpgroups 1 and 2 are the consumers k = 0, 1:
// each computes the G tiles j = k mod 2 of a window, then walks the heads
// k, k + 2, ... of the group over all of the window's j tiles.
constexpr int XS = 3;                 // stages of a consumer's x ring
constexpr int GC = 4;                 // j tiles of G a window keeps (a chunk of 256 rows)
constexpr int HEAD_GROUP = 8;         // heads of a block when the chunk fits one window
constexpr int SCAN_THREADS = 384;     // producer + two consumer warpgroups
constexpr int ROW_BYTES = 128;        // a row of a 64-column bf16 block
constexpr int BLOCK = TILE * ROW_BYTES;  // a 64 x 64 bf16 block, 8 KB
constexpr int GTILE = TILE * TILE;    // floats of a G tile
// A consumer's unit of work is one head over one window of j tiles; a unit's
// cum and dt are staged in shared memory: cum and dt of the window's rows, then
// cum of the i tile's rows
constexpr int UNIT = 2 * GC * TILE + TILE;

struct ScanBars {
    uint64_t c_full;
    uint64_t b_full[2], b_empty[2];
    uint64_t x_full[2][XS], x_empty[2][XS];
};

// Byte offsets in shared memory, each 1024-aligned (the swizzle's atoms).
template <int N> struct ScanSmem {
    static constexpr int NB = N / 64;                          // 64-column blocks of B and C
    static constexpr size_t C = 0;                             // C_i: NB blocks
    static constexpr size_t B = C + NB * BLOCK;                // B_j: one stage per consumer
    static constexpr size_t X = B + 2 * NB * BLOCK;            // x_j: XS stages per consumer
    static constexpr size_t H = X + 2 * XS * BLOCK;            // terms of 64 rows of h, per consumer
    static constexpr size_t G = H + 2 * TERMS * BLOCK;         // G: GC float32 tiles
    static constexpr size_t U = G + (size_t)GC * GTILE * sizeof(float);  // cum, dt: 2 units per consumer
    static constexpr size_t BARS = U + 2 * 2 * UNIT * sizeof(float);
    static constexpr size_t BYTES = BARS + sizeof(ScanBars) + 1024;  // + room to align
};

// exp(x) in float32 to a few ulp, for x <= 0: 2^t e^c with t = x log2 e
// rounded and c = x - t ln 2 carried past float32 (t alone would cost up to 60
// ulp at the exponents of a chunk), on one MUFU.EX2 and four FMA-pipe
// instructions.  Results below 2^-126 flush to zero: such a decay adds less
// than 1e-35 to an output.
__device__ __forceinline__ float exp_f32(float x) {
    constexpr float L2E = 1.44269502162933349609375f;     // log2 e rounded to float32
    constexpr float LN2_HI = 0.693147182464599609375f;    // ln 2 rounded to float32
    constexpr float LN2_LO = -1.9046542121259336e-09f;    // ln 2 - LN2_HI
    const float t = x * L2E;
    const float c = fmaf(-t, LN2_LO, fmaf(-t, LN2_HI, x));  // x - t ln 2
    float r;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(t));
    return fmaf(r, c, r);  // 2^t (1 + c)
}

// Two float32 values a, b as TERMS bf16 words, the largest first: word t holds
// the bf16 of what terms 0..t-1 leave of each (a in the low half), the same
// terms as bf16_round takes one value at a time.
__device__ __forceinline__ void split_pair(float a, float b, uint32_t (&w)[TERMS]) {
#pragma unroll
    for (int tm = 0; tm < TERMS; ++tm) {
        w[tm] = pack_bf16(a, b);
        if (tm + 1 < TERMS) {
            a = __fsub_rn(a, __uint_as_float(w[tm] << 16));
            b = __fsub_rn(b, __uint_as_float(w[tm] & 0xffff0000u));
        }
    }
}

// One term's product into the accumulator, d += A . B: the scores (A, in
// registers) against x_j, and C_i against a term of h (both in shared memory).
__device__ __forceinline__ void term_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    hopper::wgmma_rs_m64n64k16(d, a, db, 1);
}

__device__ __forceinline__ void term_ss(float (&d)[32], uint64_t da, uint64_t db) {
    hopper::wgmma_ss_m64n64k16<1>(d, da, db, 1);
}

template <int N>
__global__ void __launch_bounds__(SCAN_THREADS, 1)
ssd_chunk_scan(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_b,
               const __grid_constant__ CUtensorMap tm_c, const bf16* __restrict__ x,
               const float* __restrict__ dt, const float* __restrict__ cum,
               const float* __restrict__ h, const float* __restrict__ dskip, bf16* __restrict__ y,
               int s, int q, int heads, int group, int hrow) {
    using namespace hopper;
    using L = ScanSmem<N>;
    constexpr int NB = L::NB;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t pad = (1024 - (smem_addr(smem_raw) & 1023)) & 1023;
    uint8_t* sm = smem_raw + pad;
    ScanBars& bar = *reinterpret_cast<ScanBars*>(sm + L::BARS);

    const int nc = s / q;
    const int ntiles = (q + TILE - 1) / TILE;
    const int ngroups = (heads + group - 1) / group;
    const int ib = ntiles - 1 - (int)(blockIdx.x % ntiles);
    int rest = (int)(blockIdx.x / ntiles);
    const int g = rest % ngroups;
    rest /= ngroups;
    const int c = rest % nc, bg = rest / nc;
    const int h0 = g * group, nh = min(group, heads - h0);  // this block's heads
    const int i0 = ib * TILE;
    const int nj = ib + 1;                                   // j tiles: 0..ib
    const int nwin = (nj + GC - 1) / GC;
    const int crow = c * q;                                  // the chunk's first row

    if (threadIdx.x == 0) {
        mbar_init(&bar.c_full, 1);
        for (int k = 0; k < 2; ++k) {
            mbar_init(&bar.b_full[k], 1);
            mbar_init(&bar.b_empty[k], 128);
            for (int st = 0; st < XS; ++st) {
                mbar_init(&bar.x_full[k][st], 1);
                mbar_init(&bar.x_empty[k][st], 128);
            }
        }
        mbar_fence_init();
    }
    __syncthreads();

    // the warpgroup, through a shuffle so that the compiler knows it is the same
    // in every lane of a warp
    const int wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
    if (wgi == 0) {
        // ------------------------------------------------------- producer
        setmaxnreg_dec<40>();
        const int k = threadIdx.x / 32;  // the consumer this warp feeds
        if (k < 2 && (threadIdx.x & 31) == 0) {
            if (k == 0) {
                tma_prefetch(&tm_x);
                tma_prefetch(&tm_b);
                tma_prefetch(&tm_c);
                mbar_arrive_expect_tx(&bar.c_full, NB * BLOCK);
                for (int b = 0; b < NB; ++b) {
                    tma_load_3d(sm + L::C + b * BLOCK, &tm_c, &bar.c_full, 64 * b, crow + i0, bg);
                }
            }
            int nb = 0, nx = 0;  // B and x tiles loaded for consumer k
            for (int w = 0; w < nwin; ++w) {
                const int ja = w * GC, jz = min(nj, ja + GC);
                for (int j = ja + k; j < jz; j += 2, ++nb) {
                    mbar_wait(&bar.b_empty[k], (nb & 1) ^ 1);  // the first round passes
                    mbar_arrive_expect_tx(&bar.b_full[k], NB * BLOCK);
                    for (int b = 0; b < NB; ++b) {
                        tma_load_3d(sm + L::B + (k * NB + b) * BLOCK, &tm_b, &bar.b_full[k], 64 * b,
                                    crow + j * TILE, bg);
                    }
                }
                for (int hh = k; hh < nh; hh += 2) {
                    const int bh = bg * heads + h0 + hh;
                    if (c > 0 && w == nwin - 1) {  // the state entering the chunk, for C_i . h^T
                        prefetch_l2(h + ((size_t)bh * nc + c) * N * P, N * P * sizeof(float));
                    }
                    for (int j = ja; j < jz; ++j, ++nx) {
                        const int st = nx % XS;
                        mbar_wait(&bar.x_empty[k][st], ((nx / XS) & 1) ^ 1);
                        mbar_arrive_expect_tx(&bar.x_full[k][st], BLOCK);
                        tma_load_4d(sm + L::X + (k * XS + st) * BLOCK, &tm_x, &bar.x_full[k][st], 0,
                                    bh % hrow, crow + j * TILE, bh / hrow);
                    }
                }
            }
        }
        return;
    }

    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    const int k = wgi - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r0 = 16 * warp + lane / 4;  // the accumulator rows r0 and r0 + 8 of the tile
    const int col0 = 2 * (lane % 4);      // and its columns 8 jj + col0 + {0, 1}
    const int ia = i0 + r0, ib8 = ia + 8; // those rows in the chunk
    const uint32_t c_base = smem_addr(sm + L::C);
    const uint32_t b_base = smem_addr(sm + L::B + k * NB * BLOCK);
    uint8_t* hbuf = sm + L::H + k * TERMS * BLOCK;
    const uint32_t h_base = smem_addr(hbuf);
    // G tile jw as float4s: accumulator values 4 jj .. 4 jj + 3 of thread t at
    // gs4[jw GTILE / 4 + jj 128 + t], so a warp's reads and writes are contiguous
    float4* gs4 = reinterpret_cast<float4*>(sm + L::G);
    float* ubuf = reinterpret_cast<float*>(sm + L::U) + k * 2 * UNIT;

    // This consumer's units: window w = u / mine, head k + 2 (u % mine).  Unit
    // u's cum and dt go to ubuf + (u % 2) UNIT by cp.async while unit u - 1
    // computes; rows past the chunk read as zeros.
    const int mine = nh > k ? (nh - k + 1) / 2 : 0;
    const int units = mine * nwin;
    auto stage_unit = [&](int u) {
        if (u < units) {
            const int w = u / mine, hh = k + 2 * (u % mine);
            const size_t row0 = (size_t)(bg * heads + h0 + hh) * s + crow;
            const int r0w = w * GC * TILE, rows = (min(nj, (w + 1) * GC) - w * GC) * TILE;
            float* dst = ubuf + (u % 2) * UNIT;
            for (int e = t; e < rows; e += 128) {
                const int jc = r0w + e;
                const bool in = jc < q;
                cp_async_4(dst + e, cum + row0 + (in ? jc : 0), in);
                cp_async_4(dst + GC * TILE + e, dt + row0 + (in ? jc : 0), in);
            }
            if (t < TILE) {
                const bool in = i0 + t < q;
                cp_async_4(dst + 2 * GC * TILE + t, cum + row0 + (in ? i0 + t : 0), in);
            }
        }
        cp_async_commit();  // an empty group past the last unit keeps the count
    };
    stage_unit(0);
    int u = 0;

    mbar_wait(&bar.c_full, 0);
    float acc[32];
    int nb = 0, nx = 0;
    for (int w = 0; w < nwin; ++w) {
        const int ja = w * GC, jz = min(nj, ja + GC);
        if (w > 0) named_barrier(1, 256);  // both consumers are done with the last window's G

        // G_ij = C_i . B_j^T, both K-major, once for every head of the block
        for (int j = ja + k; j < jz; j += 2, ++nb) {
            mbar_wait(&bar.b_full[k], nb & 1);
            float gacc[32];
#pragma unroll
            for (int e = 0; e < 32; ++e) gacc[e] = 0.f;
            fence_regs(gacc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < N / 16; ++kk) {
                const uint32_t off = (kk / 4) * BLOCK + (kk % 4) * 32;
                wgmma_ss_m64n64k16<0>(gacc, make_desc_sw128(c_base + off, 0, 1024),
                                      make_desc_sw128(b_base + off, 0, 1024), 1);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(gacc);
            mbar_arrive(&bar.b_empty[k]);
            float4* gt = gs4 + (j - ja) * (GTILE / 4);
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
                gt[jj * 128 + t] =
                    make_float4(gacc[4 * jj], gacc[4 * jj + 1], gacc[4 * jj + 2], gacc[4 * jj + 3]);
            }
        }
        named_barrier(1, 256);  // every G tile of the window is written

        for (int hh = k; hh < nh; hh += 2, ++u) {
            const int bh = bg * heads + h0 + hh;
            // the chunk's first row of the head in x and y; the head's rows lie hrow apart
            const size_t row0 = ((size_t)(bh / hrow) * s + crow) * hrow + bh % hrow;
            const bool last = w == nwin - 1;             // the head's sums end in this window
            named_barrier(2 + k, 128);  // every thread is done with unit u - 1's buffer
            stage_unit(u + 1);
            cp_async_wait_group<1>();   // unit u has landed
            named_barrier(2 + k, 128);  // for every thread
            const float* cw = ubuf + (u % 2) * UNIT;  // cum of the window's rows
            const float* dw = cw + GC * TILE;          // dt of the window's rows
            const float* cwi = dw + GC * TILE;         // cum of the i tile's rows
            const float4* hc = reinterpret_cast<const float4*>(h + ((size_t)bh * nc + c) * N * P);
            // 16-byte pieces of 64 rows of h: idx = t + 128 pc is row idx / 8,
            // piece pair idx % 8 (the producer has asked for h in L2)
            float4 hv[8];
            auto load_h = [&](int half) {
#pragma unroll
                for (int pc = 0; pc < 4; ++pc) {
                    const int idx = t + 128 * pc;
                    hv[2 * pc] = hc[half * 64 * (P / 4) + 2 * idx];
                    hv[2 * pc + 1] = hc[half * 64 * (P / 4) + 2 * idx + 1];
                }
            };
            const float ca = cwi[r0], cb = cwi[r0 + 8];
            if (w == 0) {
#pragma unroll
                for (int e = 0; e < 32; ++e) acc[e] = 0.f;
            }

            // The scores of j tile j in float32 on G's accumulator layout, split
            // into TERMS bf16 A words of each k-step: at[k-step][term][word].
            // `masked` (std::true_type or std::false_type) says whether the tile
            // holds a pair above the diagonal or a row or column past the chunk.
            auto scores = [&](int j, uint32_t (&at)[4][TERMS][4], auto masked) {
                constexpr bool MASKED = decltype(masked)::value;
                const int j0 = j * TILE;
                const float4* gt = gs4 + (j - ja) * (GTILE / 4);
#pragma unroll
                for (int jj = 0; jj < 8; ++jj) {
                    const int jc = j0 + 8 * jj + col0;
                    const int jw = (j - ja) * TILE + 8 * jj + col0;  // the column in the window
                    const float2 cjv = *reinterpret_cast<const float2*>(cw + jw);
                    const float2 djv = *reinterpret_cast<const float2*>(dw + jw);
                    const float cj[2] = {cjv.x, cjv.y}, dj[2] = {djv.x, djv.y};
                    const float4 g4 = gt[jj * 128 + t];
                    const float g[4] = {g4.x, g4.y, g4.z, g4.w};
                    // the decay, in float32; the exponent above the diagonal is never taken
                    float v[4] = {0.f, 0.f, 0.f, 0.f};
                    // in a masked tile, skip a column group above every row of the warp
                    if (!MASKED || j0 + 8 * jj <= i0 + 16 * warp + 15) {
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int i = e < 2 ? ia : ib8;
                            const float ci = e < 2 ? ca : cb;
                            // a pair above the diagonal or past the chunk takes exp(0), then 0
                            const bool in = !MASKED || (jc + (e & 1) <= i && i < q);
                            const float d = in ? __fsub_rn(ci, cj[e & 1]) : 0.f;
                            const float sv = __fmul_rn(__fmul_rn(g[e], exp_f32(d)),
                                                       dj[e & 1]);
                            v[e] = in ? sv : 0.f;
                        }
                    }
                    // words 2 (jj % 2) and 2 (jj % 2) + 1 of k-step jj / 2: rows r0 and r0 + 8
                    uint32_t w0[TERMS], w1[TERMS];
                    split_pair(v[0], v[1], w0);
                    split_pair(v[2], v[3], w1);
#pragma unroll
                    for (int tm = 0; tm < TERMS; ++tm) {
                        at[jj / 2][tm][2 * (jj % 2)] = w0[tm];
                        at[jj / 2][tm][2 * (jj % 2) + 1] = w1[tm];
                    }
                }
            };
            // a tile wholly on or below the diagonal, inside the chunk, needs no mask
            auto make_scores = [&](int j, uint32_t (&at)[4][TERMS][4]) {
                if (j < ib && i0 + TILE <= q) {
                    scores(j, at, std::false_type{});
                } else {
                    scores(j, at, std::true_type{});
                }
            };

            // intra-chunk term, scores . x_j: tile j's products run on the
            // tensor cores while the CUDA cores make tile j + 1's scores.  Every
            // k-step is issued, with no branch and no register copy between a
            // wgmma fence and its products: either can make ptxas serialise
            // every wgmma of the kernel (C7513, C7520).  So the two A buffers
            // take turns by an unrolled pair of steps, and the rows of a ragged
            // tile past the chunk are zeroed in x_j (a TMA box reads on into the
            // next chunk) rather than skipped.
            auto step = [&](int j, uint32_t (&cur)[4][TERMS][4], uint32_t (&nxt)[4][TERMS][4]) {
                const int st = nx % XS;
                mbar_wait(&bar.x_full[k][st], (nx / XS) & 1);
                uint8_t* xt = sm + L::X + (k * XS + st) * BLOCK;
                const int jrows = min(TILE, q - j * TILE);
                if (jrows < TILE) {  // a uniform branch: the chunk ends inside this tile
                    for (int e = jrows * (ROW_BYTES / 16) + t; e < TILE * (ROW_BYTES / 16); e += 128) {
                        reinterpret_cast<uint4*>(xt)[e] = make_uint4(0u, 0u, 0u, 0u);
                    }
                    fence_proxy_async();
                    named_barrier(2 + k, 128);
                }
                const uint32_t x_base = smem_addr(xt);
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
                    for (int tm = 0; tm < TERMS; ++tm) fence_regs(cur[kk][tm]);
                }
                fence_regs(acc);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    // B = x_j, (j, p) as stored: MN-major
                    const uint64_t db = make_desc_sw128(x_base + kk * 16 * ROW_BYTES, BLOCK, 1024);
#pragma unroll
                    for (int tm = TERMS - 1; tm >= 0; --tm) {  // the smallest term first
                        term_rs(acc, cur[kk][tm], db);
                    }
                }
                wgmma_commit();
                if (j + 1 < jz) {
                    make_scores(j + 1, nxt);
                } else if (last && c > 0) {
                    load_h(0);  // the first 64 rows of h, for C_i . h^T next
                }
                wgmma_wait<0>();
                fence_regs(acc);
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
                    for (int tm = 0; tm < TERMS; ++tm) fence_regs(cur[kk][tm]);
                }
                mbar_arrive(&bar.x_empty[k][st]);
                ++nx;
            };
            uint32_t at[4][TERMS][4], an[4][TERMS][4];
            make_scores(ja, at);
            for (int j = ja; j < jz; j += 2) {
                step(j, at, an);
                if (j + 1 < jz) step(j + 1, an, at);
            }
            if (!last) continue;  // the head's later windows follow

            // inter-chunk term C_i . h_c^T; h_0 is zero.  64 rows of h at a
            // time, split into TERMS bf16 blocks laid out as TMA would
            // (MN-major B operands), the smallest term first
            float inter[32];
#pragma unroll
            for (int e = 0; e < 32; ++e) inter[e] = 0.f;
            if (c > 0) {
#pragma unroll 1
                for (int half = 0; half < NB; ++half) {
                    named_barrier(2 + k, 128);  // the last products are done with hbuf
#pragma unroll
                    for (int pc = 0; pc < 4; ++pc) {
                        const int idx = t + 128 * pc, r = idx / 8, ch = idx % 8;
                        uint32_t w[4][TERMS];
                        split_pair(hv[2 * pc].x, hv[2 * pc].y, w[0]);
                        split_pair(hv[2 * pc].z, hv[2 * pc].w, w[1]);
                        split_pair(hv[2 * pc + 1].x, hv[2 * pc + 1].y, w[2]);
                        split_pair(hv[2 * pc + 1].z, hv[2 * pc + 1].w, w[3]);
                        const int off = r * ROW_BYTES + ((ch ^ (r & 7)) << 4);
#pragma unroll
                        for (int tm = 0; tm < TERMS; ++tm) {
                            *reinterpret_cast<uint4*>(hbuf + tm * BLOCK + off) =
                                make_uint4(w[0][tm], w[1][tm], w[2][tm], w[3][tm]);
                        }
                    }
                    if (half + 1 < NB) load_h(half + 1);  // under this half's products
                    fence_proxy_async();        // the terms are visible to wgmma
                    named_barrier(2 + k, 128);  // and every thread's are written
                    fence_regs(inter);
                    wgmma_fence();
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk) {
                        // A = C_i, columns [64 half + 16 kk, + 16): K-major
                        const uint64_t da = make_desc_sw128(c_base + half * BLOCK + kk * 32, 0, 1024);
#pragma unroll
                        for (int tm = TERMS - 1; tm >= 0; --tm) {
                            term_ss(inter, da,
                                    make_desc_sw128(h_base + tm * BLOCK + kk * 16 * ROW_BYTES, BLOCK, 1024));
                        }
                    }
                    wgmma_commit();
                    wgmma_wait<0>();
                    fence_regs(inter);
                }
            }

            // out = (intra + exp(cum) inter) + D x, cast once
            const float dv = dskip[bh];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int i = half ? ib8 : ia;
                if (i >= q) continue;
                const float ec = expf(half ? cb : ca);
                const size_t at_row = (row0 + (size_t)i * hrow) * P;
#pragma unroll
                for (int jj = 0; jj < 8; ++jj) {
                    const int p = 8 * jj + col0;
                    const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + at_row + p);
                    const int e = 4 * jj + 2 * half;
                    const float y0 = __fadd_rn(__fadd_rn(acc[e], __fmul_rn(ec, inter[e])),
                                               __fmul_rn(dv, __bfloat162float(xv.x)));
                    const float y1 = __fadd_rn(__fadd_rn(acc[e + 1], __fmul_rn(ec, inter[e + 1])),
                                               __fmul_rn(dv, __bfloat162float(xv.y)));
                    *reinterpret_cast<__nv_bfloat162*>(y + at_row + p) = __floats2bfloat162_rn(y0, y1);
                }
            }
        }
    }
}

// Launch 1 (see the header note): one block per (batch entry, chunk, group
// of heads), each taking its place from a ticket, chunk outermost; two blocks
// an SM.  Warps 0-3 are the consumer warpgroup: they first scan dt a of one
// head each (cum, w and the chunk's total), then walk the group's heads:
// S_c^T = (w x)^T B over the chunk's tiles on wgmma, then the recurrence onto
// h.  Lane 0 of warp 4, the producer, loads the chunk's B tiles into a ring
// of GC stages (once for the group's heads) and each head's x tiles into a
// ring of STATE_XS stages.
constexpr int STATE_XS = 3;            // stages of the x ring
constexpr int STATE_GROUP = 2;         // heads of a block when the chunk fits the B ring
constexpr int STATE_THREADS = 160;     // a consumer warpgroup and a producer warp
// floats of w (and of the cum scratch) a block keeps: its heads' rows, each
// head's rounded up to whole tiles
constexpr int STATE_W = STATE_GROUP * GC * TILE > MAX_CHUNK ? STATE_GROUP * GC * TILE : MAX_CHUNK;

// A step of the consumer: KS k-steps of a tile, SPT steps a tile.  At N 128
// the accumulator (64 registers) leaves room for two buffers of two k-steps'
// A words, not of four (with four, at 168 registers a thread, ptxas spilled
// and serialised every wgmma, C7512).
template <int N> struct StateStep {
    static constexpr int KS = N == 128 ? 2 : 4;
    static constexpr int SPT = 4 / KS;
};

struct StateBars {
    uint64_t b_full[GC], b_empty[GC];
    uint64_t x_full[STATE_XS], x_empty[STATE_XS];
    int ticket;
};

// Byte offsets in shared memory; the tiles 1024-aligned (the swizzle's atoms).
// 107.7 KB at N 128: two blocks fit an SM's 228 KB.
template <int N> struct StateSmem {
    static constexpr int NB = N / 64;                              // 64-column blocks of B
    static constexpr size_t B = 0;                                 // B_j: GC stages
    static constexpr size_t X = B + (size_t)GC * NB * BLOCK;       // x_j: STATE_XS stages
    static constexpr size_t W = X + STATE_XS * BLOCK;              // w of each head
    static constexpr size_t CUM = W + STATE_W * sizeof(float);     // cum of each head, a scratch
    static constexpr size_t TOT = CUM + STATE_W * sizeof(float);   // each head's total
    static constexpr size_t BARS = TOT + (STATE_GROUP * sizeof(float) + 15) / 16 * 16;
    static constexpr size_t BYTES = BARS + sizeof(StateBars) + 1024;  // + room to align
};

// The chained scan's flags (cutlass/barrier.h's pattern).  A waiter's thread
// 0 spins on an acquire load, then a barrier hands the order on to its
// warpgroup; a writer's warpgroup meets at a barrier, then its thread 0
// fences at gpu scope (which also releases what the others wrote before the
// barrier) and sets the flag.  A wait that lasts for billions of cycles is a
// deadlock, not a slow predecessor: it traps, as mbar_wait does.
__device__ __forceinline__ void flag_wait(const int* flag) {
    long long start = clock64();
    for (int spins = 1;; ++spins) {
        int v;
        asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n" : "=r"(v) : "l"(flag) : "memory");
        if (v != 0) return;
        if ((spins & 1023) == 0 && clock64() - start > (1ll << 34)) __trap();
    }
}

__device__ __forceinline__ void flag_release(int* flag) {
    asm volatile("fence.acq_rel.gpu;\nred.relaxed.gpu.global.add.s32 [%0], 1;\n" ::"l"(flag) : "memory");
}

// cum of one head's chunk by one warp: the float32 products dt a added in
// float64, each prefix rounded once (as ssd_scan_fwd and the plain version
// do), into cums; dts holds dt on entry and w_j = exp(total - cum_j) dt_j on
// return.  Returns the chunk's total, cum[q - 1].
__device__ __forceinline__ float chunk_cumsum(float* dts, float* cums, float av, int q, int lane) {
    const int seg = (q + 31) / 32;
    const int lo = min(lane * seg, q), hi = min(lo + seg, q);
    double run = 0.0;
    for (int t = lo; t < hi; ++t) run += (double)__fmul_rn(dts[t], av);
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
    }
    double pre = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) pre = 0.0;
    for (int t = lo; t < hi; ++t) {
        pre += (double)__fmul_rn(dts[t], av);
        cums[t] = __double2float_rn(pre);
    }
    __syncwarp();
    const float total = cums[q - 1];
    for (int t = lane; t < q; t += 32) dts[t] = __fmul_rn(expf(__fsub_rn(total, cums[t])), dts[t]);
    __syncwarp();
    return total;
}

// One term's product into the state, d += A . B: (w x)^T in registers
// against B_j, MN-major in shared memory.
template <int M>
__device__ __forceinline__ void state_term(float (&d)[M], const uint32_t (&a)[4], uint64_t db) {
    hopper::wgmma_rs(d, a, db, 1);
}

template <int N>
__global__ void __launch_bounds__(STATE_THREADS, 2)
ssd_chunk_state(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_b,
                const float* __restrict__ dt, const float* __restrict__ a, float* __restrict__ cum,
                float* __restrict__ h, float* __restrict__ states, int* __restrict__ sync, int s,
                int q, int heads, int group, int hrow) {
    using namespace hopper;
    using L = StateSmem<N>;
    constexpr int NB = L::NB;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t pad = (1024 - (smem_addr(smem_raw) & 1023)) & 1023;
    uint8_t* sm = smem_raw + pad;
    StateBars& bar = *reinterpret_cast<StateBars*>(sm + L::BARS);

    const int nc = s / q;
    const int ntiles = (q + TILE - 1) / TILE;
    const int ngroups = (heads + group - 1) / group;
    const int bgs = (int)(gridDim.x / ((unsigned)nc * ngroups));  // batch entries
    if (threadIdx.x == 0) {
        // chunk outermost: every block that waits for chunk c - 1 finds that
        // chunk's blocks already started, whatever order blocks are run in
        bar.ticket = atomicAdd(sync, 1);
        for (int st = 0; st < GC; ++st) {
            mbar_init(&bar.b_full[st], 1);
            mbar_init(&bar.b_empty[st], 128);
        }
        for (int st = 0; st < STATE_XS; ++st) {
            mbar_init(&bar.x_full[st], 1);
            mbar_init(&bar.x_empty[st], 128);
        }
        mbar_fence_init();
    }
    __syncthreads();
    const int ticket = bar.ticket;
    const int g = ticket % ngroups;
    const int bg = (ticket / ngroups) % bgs;
    const int c = ticket / (ngroups * bgs);
    const int h0 = g * group, nh = min(group, heads - h0);  // this block's heads
    const int crow = c * q;                                  // the chunk's first row
    const int qp = ntiles * TILE;                            // a head's stride in w and cum

    if (threadIdx.x >= 128) {
        // ---------------------------------------------------------- producer
        if (c == nc - 1 || threadIdx.x != 128) return;  // the last chunk needs no state
        tma_prefetch(&tm_b);
        tma_prefetch(&tm_x);
        int nx = 0;
        for (int hh = 0; hh < nh; ++hh) {
            const int bh = bg * heads + h0 + hh;
            for (int j = 0; j < ntiles; ++j, ++nx) {
                if (hh == 0) {  // B_j, once for the group
                    const int sb = j % GC;
                    mbar_wait(&bar.b_empty[sb], ((j / GC) & 1) ^ 1);  // the first round passes
                    mbar_arrive_expect_tx(&bar.b_full[sb], NB * BLOCK);
                    for (int b = 0; b < NB; ++b) {
                        tma_load_3d(sm + L::B + (sb * NB + b) * BLOCK, &tm_b, &bar.b_full[sb], 64 * b,
                                    crow + j * TILE, bg);
                    }
                }
                const int st = nx % STATE_XS;
                mbar_wait(&bar.x_empty[st], ((nx / STATE_XS) & 1) ^ 1);
                mbar_arrive_expect_tx(&bar.x_full[st], BLOCK);
                tma_load_4d(sm + L::X + st * BLOCK, &tm_x, &bar.x_full[st], 0, bh % hrow, crow + j * TILE,
                            bh / hrow);
            }
        }
        return;
    }

    // ------------------------------------------------------------ consumer
    const int t = threadIdx.x, warp = t / 32, lane = t % 32;
    const int gq = lane / 4, tq = lane % 4;
    float* wsm = reinterpret_cast<float*>(sm + L::W);
    float* csm = reinterpret_cast<float*>(sm + L::CUM);
    float* tots = reinterpret_cast<float*>(sm + L::TOT);

    // cum of every head of the block, a warp a head at a time: cum to
    // memory, w and the total to shared memory
    for (int hh = warp; hh < nh; hh += 4) {
        const int bh = bg * heads + h0 + hh;
        const size_t row0 = (size_t)bh * s + crow;
        float* dts = wsm + hh * qp;
        float* cums = csm + hh * qp;
        for (int e0 = 0; e0 < q; e0 += 32 * 8) {  // eight loads in flight a lane
            float v[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int e = e0 + lane + 32 * i;
                v[i] = e < q ? dt[row0 + e] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                if (e0 + lane + 32 * i < q) dts[e0 + lane + 32 * i] = v[i];
            }
        }
        __syncwarp();
        const float total = chunk_cumsum(dts, cums, a[bh], q, lane);
        for (int e = lane; e < q; e += 32) cum[row0 + e] = cums[e];
        if (lane == 0) tots[hh] = total;
    }
    named_barrier(1, 128);  // w and the totals of every head are written
    if (c == 0) {  // h_0 = 0
        for (int hh = 0; hh < nh; ++hh) {
            float4* h0v = reinterpret_cast<float4*>(h + (size_t)(bg * heads + h0 + hh) * nc * N * P);
            for (int e = t; e < N * P / 4; e += 128) h0v[e] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
    }
    if (c == nc - 1) return;

    // A of the product, (w x)^T: row p, column j of a k-step.  ldmatrix.trans
    // of the x tile (rows j, columns p, as TMA laid it out) gives each lane
    // its four words (rows p = 16 warp + gq and + 8, columns j = 2 tq, 2 tq +
    // 1 and + 8); each value is scaled by w_j in float32 and split into
    // TERMS bf16 words, KS k-steps at a time (StateStep).  `masked`: the tile
    // runs past the chunk's last row, and x there (the next chunk's, read by
    // the TMA box) becomes zero.
    constexpr int KS = StateStep<N>::KS, SPT = StateStep<N>::SPT;
    const int nsteps = ntiles * SPT;
    int nx = 0;
    const float* ws = wsm;
    auto make_a = [&](int u, auto& at, auto masked) {
        constexpr bool MASKED = decltype(masked)::value;
        constexpr int KS = StateStep<N>::KS, SPT = StateStep<N>::SPT;
        const int j = u / SPT, part = u % SPT;
        const int st = nx % STATE_XS;
        if (part == 0) mbar_wait(&bar.x_full[st], (nx / STATE_XS) & 1);
        const uint8_t* xt = sm + L::X + st * BLOCK;
        const int jrows = q - j * TILE;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
            const int kk = part * KS + ks;
            uint32_t r[4];
            const int row = kk * 16 + ((lane >> 4) << 3) + (lane & 7);
            const int piece = 2 * warp + ((lane >> 3) & 1);
            ldmatrix_x4_trans(r, xt + row * ROW_BYTES + ((piece ^ (row & 7)) << 4));
            const float2 wlo = *reinterpret_cast<const float2*>(ws + j * TILE + kk * 16 + 2 * tq);
            const float2 whi = *reinterpret_cast<const float2*>(ws + j * TILE + kk * 16 + 8 + 2 * tq);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float2 wv = i < 2 ? wlo : whi;
                float v0 = __fmul_rn(__uint_as_float(r[i] << 16), wv.x);
                float v1 = __fmul_rn(__uint_as_float(r[i] & 0xffff0000u), wv.y);
                if (MASKED) {
                    const int jr = kk * 16 + (i >> 1) * 8 + 2 * tq;
                    v0 = jr < jrows ? v0 : 0.f;
                    v1 = jr + 1 < jrows ? v1 : 0.f;
                }
                uint32_t wd[TERMS];
                split_pair(v0, v1, wd);
#pragma unroll
                for (int tm = 0; tm < TERMS; ++tm) at[ks][tm][i] = wd[tm];
            }
        }
        if (part == SPT - 1) {
            // the tile is in registers.  ldmatrix read it through the generic
            // proxy and the next TMA load writes the stage through the async
            // one: without the fence that write could overtake the reads
            fence_proxy_async();
            mbar_arrive(&bar.x_empty[st]);
            ++nx;
        }
    };
    auto next_a = [&](int u, auto& at) {
        if ((u / StateStep<N>::SPT + 1) * TILE <= q) {
            make_a(u, at, std::false_type{});
        } else {
            make_a(u, at, std::true_type{});
        }
    };

    float acc[N / 2];
    // step u's products run on the tensor cores while the CUDA cores make
    // step u + 1's A words; no branch or register copy between a wgmma fence
    // and its products (ptxas would serialise every wgmma of the kernel), so
    // the two A buffers take turns by an unrolled pair of steps
    auto step = [&](int u, auto& cur, auto& nxt) {
        constexpr int KS = StateStep<N>::KS, SPT = StateStep<N>::SPT;
        const int j = u / SPT, part = u % SPT, sb = j % GC;
        mbar_wait(&bar.b_full[sb], (j / GC) & 1);
        const uint32_t b_base = smem_addr(sm + L::B + sb * NB * BLOCK) + part * KS * 16 * ROW_BYTES;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
            for (int tm = 0; tm < TERMS; ++tm) fence_regs(cur[ks][tm]);
        }
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
            // B = B_j, (j, n) as stored: MN-major, its 64-column blocks BLOCK apart
            const uint64_t db = make_desc_sw128(b_base + ks * 16 * ROW_BYTES, BLOCK, 1024);
#pragma unroll
            for (int tm = TERMS - 1; tm >= 0; --tm) {  // the smallest term first
                state_term(acc, cur[ks][tm], db);
            }
        }
        wgmma_commit();
        if (u + 1 < nsteps) next_a(u + 1, nxt);
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
            for (int tm = 0; tm < TERMS; ++tm) fence_regs(cur[ks][tm]);
        }
        // the ring turns only past GC tiles
        if (ntiles > GC && part == SPT - 1) mbar_arrive(&bar.b_empty[sb]);
    };

    int* flags = sync + 1;  // flags[bh nc + c]: h_c of head bh is written
    for (int hh = 0; hh < nh; ++hh) {
        const int bh = bg * heads + h0 + hh;
        ws = wsm + hh * qp;
#pragma unroll
        for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;
        uint32_t at[KS][TERMS][4], an[KS][TERMS][4];
        next_a(0, at);
        for (int u = 0; u < nsteps; u += 2) {
            step(u, at, an);
            if (u + 1 < nsteps) step(u + 1, an, at);
        }

        // acc[4 jj + e] is S_c^T at p = 16 warp + gq + 8 (e / 2), n = 8 jj +
        // 2 tq + e % 2: S_c[n][p] at offset n P + p of a (N, P) state
        auto at_np = [&](int e) {
            return (8 * (e / 4) + 2 * tq + (e & 1)) * P + 16 * warp + gq + 8 * ((e & 3) >> 1);
        };
        if (states != nullptr) {  // the check output
            float* sc = states + ((size_t)bh * (nc - 1) + c) * N * P;
#pragma unroll
            for (int e = 0; e < N / 2; ++e) sc[at_np(e)] = acc[e];
        }
        // h_{c+1} = exp(total_c) h_c + S_c, once chunk c - 1's block has
        // written h_c; h_0 is zero
        const bool chained = c > 0;
        if (chained) {
            if (t == 0) flag_wait(flags + (size_t)bh * nc + c);
            named_barrier(2, 128);
        }
        const float et = expf(tots[hh]);
        const float* hc = h + ((size_t)bh * nc + c) * N * P;
        float* hn = h + ((size_t)bh * nc + c + 1) * N * P;
        // every load of h_c in flight before the stores of h_{c+1}, which the
        // compiler cannot move them past
        float hv[N / 2];
#pragma unroll
        for (int e = 0; e < N / 2; ++e) hv[e] = chained ? __ldcg(hc + at_np(e)) : 0.f;  // from L2
#pragma unroll
        for (int e = 0; e < N / 2; ++e) hn[at_np(e)] = __fadd_rn(__fmul_rn(et, hv[e]), acc[e]);
        named_barrier(2, 128);  // every thread's h_{c+1} is written
        if (t == 0) flag_release(flags + (size_t)bh * nc + c + 1);
    }
}

bool takes(int n, int q, int s, int bh, int heads, int hrow) {
    return (n == 64 || n == 128) && q >= 1 && q <= MAX_CHUNK && s % q == 0 && heads >= 1 &&
           bh >= 1 && bh % heads == 0 && hrow >= 1 && bh % hrow == 0;
}

// Heads of a launch-1 block: a group of STATE_GROUP when the chunk's B tiles
// fit the ring (they are loaded once for the group), else one (the ring
// turns).
int state_group(int q) { return (q + TILE - 1) / TILE <= GC ? STATE_GROUP : 1; }

// Asks for the largest shared-memory carveout for `kernel`, once per device
// (`devices`, as hopper::allow_smem): the default may leave room for one
// block of launch 1 an SM where two fit.
template <typename Kernel>
cudaError_t max_shared_carveout(Kernel kernel, std::atomic<unsigned long long>& devices) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (devices.load(std::memory_order_relaxed) & bit) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess) devices.fetch_or(bit, std::memory_order_relaxed);
    return err;
}

long long state_blocks(int bh, int s, int q, int heads) {
    const int group = state_group(q);
    return (long long)(bh / heads) * (s / q) * ((heads + group - 1) / group);
}

template <int N>
cudaError_t chunk_state(const void* x, const void* dt, const void* a, const void* b, void* cum,
                        void* h, void* states, void* sync, int bh, int s, int q, int heads,
                        int hrow, cudaStream_t stream, int* encode_err) {
    const int bg = bh / heads;
    CUtensorMap tm_x, tm_b;
    int err = hopper::encode_bf16_4d(&tm_x, x, P, hrow, s, bh / hrow, TILE);
    if (err == 0) err = hopper::encode_bf16_3d(&tm_b, b, N, s, bg, TILE);
    if (err != 0) {
        *encode_err = err;
        return cudaErrorInvalidValue;
    }
    auto kernel = ssd_chunk_state<N>;
    constexpr size_t smem = StateSmem<N>::BYTES;
    static std::atomic<unsigned long long> smem_devices{0}, carveout_devices{0};
    cudaError_t cerr = hopper::allow_smem(kernel, smem, smem_devices);
    if (cerr == cudaSuccess) cerr = max_shared_carveout(kernel, carveout_devices);  // two blocks an SM
    if (cerr != cudaSuccess) return cerr;
    // the ticket and the flags start at zero on every launch, in stream order
    cerr = cudaMemsetAsync(sync, 0, (1 + (size_t)bh * (s / q)) * sizeof(int), stream);
    if (cerr != cudaSuccess) return cerr;
    kernel<<<(unsigned)state_blocks(bh, s, q, heads), STATE_THREADS, smem, stream>>>(
        tm_x, tm_b, static_cast<const float*>(dt), static_cast<const float*>(a),
        static_cast<float*>(cum), static_cast<float*>(h), static_cast<float*>(states),
        static_cast<int*>(sync), s, q, heads, state_group(q), hrow);
    return cudaGetLastError();
}

// Heads of a launch-2 block: a group of HEAD_GROUP when the chunk's G tiles
// fit one window, else one head for each consumer (G is made again for each
// window, and a head's sum runs over every window).
int scan_group(int q) { return (q + TILE - 1) / TILE <= GC ? HEAD_GROUP : 2; }

long long scan_blocks(int bh, int s, int q, int heads) {
    const int group = scan_group(q);
    return (long long)(bh / heads) * (s / q) * ((heads + group - 1) / group) * ((q + TILE - 1) / TILE);
}

template <int N>
cudaError_t chunk_scan(const void* x, const void* dt, const void* cum, const void* h,
                       const void* b, const void* c, const void* d, void* y, int bh, int s, int q,
                       int heads, int hrow, cudaStream_t stream, int* encode_err) {
    const int bg = bh / heads;
    CUtensorMap tm_x, tm_b, tm_c;
    int err = hopper::encode_bf16_4d(&tm_x, x, P, hrow, s, bh / hrow, TILE);
    if (err == 0) err = hopper::encode_bf16_3d(&tm_b, b, N, s, bg, TILE);
    if (err == 0) err = hopper::encode_bf16_3d(&tm_c, c, N, s, bg, TILE);
    if (err != 0) {
        *encode_err = err;
        return cudaErrorInvalidValue;
    }
    auto kernel = ssd_chunk_scan<N>;
    constexpr size_t smem = ScanSmem<N>::BYTES;
    static std::atomic<unsigned long long> smem_devices{0};
    cudaError_t cerr = hopper::allow_smem(kernel, smem, smem_devices);
    if (cerr != cudaSuccess) return cerr;
    const int group = scan_group(q);
    const unsigned blocks = (unsigned)scan_blocks(bh, s, q, heads);
    kernel<<<blocks, SCAN_THREADS, smem, stream>>>(
        tm_x, tm_b, tm_c, static_cast<const bf16*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(cum), static_cast<const float*>(h), static_cast<const float*>(d),
        static_cast<bf16*>(y), s, q, heads, group, hrow);
    return cudaGetLastError();
}

}  // namespace sp

}  // namespace

extern "C" {

// ssd_scan_fwd.  dtype 0 = float32, 1 = bfloat16 (x, B, C and the output).
// Returns a cudaError_t: 0 on success, cudaErrorInvalidValue for a head dim,
// state size, chunk or dtype that this instance does not take (bf16 at P = 64
// with N 64 or 128 is the split instance's).
int ssd_scan_fwd_launch(int dtype, int p, const void* x, const void* dt, const void* a,
                        const void* b, const void* c, const void* d, void* y, int bh, int s,
                        int n, int q, int heads, void* stream) {
    if (n < 1 || n > MAX_N || q < 1 || q > MAX_CHUNK || s % q != 0 || heads < 1 ||
        bh % heads != 0 || (dtype == 1 && p == sp::P && (n == 64 || n == 128))) {
        return cudaErrorInvalidValue;
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch<float>(p, x, dt, a, b, c, d, y, bh, s, n, q, heads, st);
    if (dtype == 1) {
        return dispatch<__nv_bfloat16>(p, x, dt, a, b, c, d, y, bh, s, n, q, heads, st);
    }
    return cudaErrorInvalidValue;
}

// The split instance: bf16 x, B, C and out, P = 64, N = 64 or 128; x, B and
// C 16-byte aligned.  x and out hold hrow heads interleaved along each
// sequence row, (BH / hrow, S, hrow, P); hrow = 1 is (BH, S, P).  Each
// returns a cudaError_t: 0 on success, cudaErrorInvalidValue for a state
// size, chunk or layout it does not take.
//
// Launch 1: cum (BH, S) and h (BH, S/q, N, P), float32, the state entering
// each chunk.  states, when not null, also gets each chunk's own state S_c,
// (BH, S/q - 1, N, P) float32: a check output.  sync holds 1 + BH S/q int32
// (the ticket and the chunks' flags) for this launch alone; it is zeroed on
// `stream` first, so two launches at once need two.  x and B are read
// through TMA maps.  Returns 0, a cudaError_t, or hopper::ENCODE_ERROR_BASE +
// the CUresult of a tensor-map encode that failed.
int ssd_chunk_state_launch(int n, const void* x, const void* dt, const void* a, const void* b,
                           void* cum, void* h, void* states, void* sync, int bh, int s, int q,
                           int heads, int hrow, void* stream) {
    if (!sp::takes(n, q, s, bh, heads, hrow) || sp::state_blocks(bh, s, q, heads) >= (1ll << 31) ||
        (long long)bh * (s / q) >= (1ll << 31) - 1) {
        return cudaErrorInvalidValue;
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int encode_err = 0;
    const cudaError_t err =
        n == 64 ? sp::chunk_state<64>(x, dt, a, b, cum, h, states, sync, bh, s, q, heads, hrow, st,
                                      &encode_err)
                : sp::chunk_state<128>(x, dt, a, b, cum, h, states, sync, bh, s, q, heads, hrow, st,
                                       &encode_err);
    return encode_err != 0 ? encode_err : (int)err;
}

// Heads of one launch-1 block at chunk length q: the heads that share each
// B tile it loads.
int ssd_chunk_state_group(int q) { return sp::state_group(q); }

// The dynamic shared memory of one launch-1 block at state size n, bytes.
int ssd_chunk_state_smem(int n) {
    return n == 64 ? (int)sp::StateSmem<64>::BYTES : n == 128 ? (int)sp::StateSmem<128>::BYTES : 0;
}

// Launch-1 blocks that run at once on one SM of the current device at state
// size n (after a launch has set the kernel's attributes), or -1 on an error.
int ssd_chunk_state_blocks_per_sm(int n) {
    int blocks = -1;
    const cudaError_t err =
        n == 64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, sp::ssd_chunk_state<64>, sp::STATE_THREADS,
                                                                sp::StateSmem<64>::BYTES)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, sp::ssd_chunk_state<128>, sp::STATE_THREADS,
                                                                sp::StateSmem<128>::BYTES);
    return err == cudaSuccess ? blocks : -1;
}

// Launch 2: out bf16, in x's layout.  x, B and C are read through TMA maps:
// their bases 16-byte aligned (rows of P = 64 and N = 64 or 128 bf16 keep every
// stride a multiple of 16 bytes).  Returns 0, a cudaError_t, or
// hopper::ENCODE_ERROR_BASE + the CUresult of a tensor-map encode that failed.
int ssd_chunk_scan_launch(int n, const void* x, const void* dt, const void* cum, const void* h,
                          const void* b, const void* c, const void* d, void* y, int bh, int s,
                          int q, int heads, int hrow, void* stream) {
    if (!sp::takes(n, q, s, bh, heads, hrow) || sp::scan_blocks(bh, s, q, heads) >= (1ll << 31)) {
        return cudaErrorInvalidValue;
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int encode_err = 0;
    const cudaError_t err =
        n == 64 ? sp::chunk_scan<64>(x, dt, cum, h, b, c, d, y, bh, s, q, heads, hrow, st, &encode_err)
                : sp::chunk_scan<128>(x, dt, cum, h, b, c, d, y, bh, s, q, heads, hrow, st, &encode_err);
    return encode_err != 0 ? encode_err : (int)err;
}

// Heads of one launch-2 block at chunk length q: the heads that share each
// C_i . B_j^T it makes.
int ssd_chunk_scan_group(int q) { return sp::scan_group(q); }

// The dynamic shared memory of one launch-2 block at state size n, bytes.
int ssd_chunk_scan_smem(int n) {
    return n == 64 ? (int)sp::ScanSmem<64>::BYTES : n == 128 ? (int)sp::ScanSmem<128>::BYTES : 0;
}

const char* ssd_scan_error_string(int err) {
    if (err >= hopper::ENCODE_ERROR_BASE) {
        static thread_local char msg[96];
        snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed with CUresult %d",
                 err - hopper::ENCODE_ERROR_BASE);
        return msg;
    }
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
