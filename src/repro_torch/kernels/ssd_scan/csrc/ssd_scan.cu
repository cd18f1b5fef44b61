// Mamba2 SSD chunked scan for Hopper (sm_90a), in two instances chosen by the
// wrapper from (dtype, P, N) alone:
//
//   1. `ssd_scan_fwd`: x, B and C in float32, or bf16 at head dims 8 and 16
//      (and at 64 with state sizes other than 64 and 128); everything in
//      float32 on the CUDA cores.
//   2. the split instance: bf16 x, B and C at P = 64, N = 64 or 128 (the
//      heads of mamba2-370m and zamba2-7b), in three launches on the tensor
//      cores (mma.sync), with float32 operands split into bf16 terms.
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
// Layout: x and out (BH, S, P), dt (BH, S), A and D (BH,), B and C (BH/heads,
// S, N) shared by the heads of one batch entry (the Pallas index map
// b // heads), all contiguous.
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
// ---- 2. the split instance (ssd_chunk_state, ssd_state_pass, ssd_chunk_scan)
// Only the C . state^T term and the state recurrence depend on earlier
// chunks (the SSD split of arXiv:2405.21060 section 6), so the scan runs as
//   ssd_chunk_state  grid BH x chunks: the chunk's cumsum (written to a
//                    (BH, S) float32 scratch) and its own state contribution
//                    S_c = B^T (w x), w_j = exp(total - cum_j) dt_j, into a
//                    (BH, chunks - 1, N, P) float32 scratch (nothing reads the
//                    state after the last chunk);
//   ssd_state_pass   one thread per four (bh, n, p) walks the chunks in order:
//                    h_0 = 0, h_{c+1} = exp(total_c) h_c + S_c, written to a
//                    (BH, chunks, N, P) float32 scratch;
//   ssd_chunk_scan   grid BH x chunks x 64-row tiles: for its 64 rows i, each
//                    64-row tile j <= i gives C_i . B_j^T, the masked decay
//                    exp(cum_i - cum_j) dt_j in float32, and scores . x_j;
//                    then exp(cum_i) (C_i . h_c^T) and D x_i.
// Every product runs on the tensor cores as mma.sync.m16n8k16 (bf16 in,
// float32 accumulators), four warps a block, operands staged by cp.async into
// padded shared tiles (rows of N + 8 or P + 8 elements: 16 bytes past a
// multiple of 128, so ldmatrix reads without bank conflicts) and read by
// ldmatrix, with .trans for the operands stored K-major the other way (B^T,
// w x, x_j and h).  The scores go from the accumulators of C . B^T straight
// into the A words of scores . x, in registers.
//
// Precision.  x, B and C are bf16 inputs and enter once.  Each operand the
// kernel derives in float32 -- the scores, w x and h -- enters as three bf16
// terms, v = t0 + t1 + t2 + r with t0 = bf16(v), t1 = bf16(v - t0), t2 =
// bf16(v - t0 - t1) and |r| <= 2^-26 |v| (each difference is exact), three
// products into the same float32 accumulator: float32 operands in all but
// name, so the instance keeps the float32 semantics of ssd_scan_fwd.  Two
// terms (hi + lo, 2^-18) were not enough: the plain version with its operands
// rounded to hi + lo moved chip_smoke.py's held-out loss of trained
// mamba2-370m by 1.7e-3 from the float32 one, past the 3e-4 that tells a
// sound scan from a faulty one.  The plain version with split_bf16=True
// rounds the same operands to t0 + t1 + t2.
//
// What bounds it.  The scan needs 24 GFLOP and 145 MB at the full-width
// scoring shape (x 256 x 2048 x 64, B and C 8 x 2048 x 128, chunk 256): 0.043
// ms of HBM time at 3.35 TB/s, 0.025 ms of bf16 tensor-core time.  This
// design spends about 90 GFLOP (C . B^T once per head, the split operands
// three times, the diagonal tiles cut to their causal 16-column groups) and
// moves about 260 MB of float32 scratch beside the inputs, so its own floor
// is about 0.12 ms by bytes; simple mma.sync code (one stage, a barrier pair
// per 64-row tile) runs far below the card's wgmma peak, so the products
// bound it.  wgmma with TMA for the largest launch, one C . B^T per (batch,
// chunk) for the heads, and fewer terms where the margin allows are for later
// versions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

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
using hopper::cp_async_16;
using hopper::cp_async_wait_all;
using hopper::ldmatrix_x4;
using hopper::ldmatrix_x4_trans;
using hopper::mma_bf16_m16n8k16;
using hopper::pack_bf16;

constexpr int P = 64;          // head dim
constexpr int TILE = 64;       // rows of a chunk tile
constexpr int THREADS = 128;   // four warps
constexpr int LDP = P + 8;     // padded row of a P-wide bf16 tile (144 bytes)
constexpr int PASS_THREADS = 256;
constexpr int TERMS = 3;       // bf16 terms of a float32 operand

// v rounded to bf16, as a float32
__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// Term t of float32 v fed as bf16 terms: term 0 = bf16(v), term t = bf16 of
// what terms 0..t-1 leave (each difference is exact in float32).
__device__ __forceinline__ float term(float v, int t) {
    float r = v;
    for (int i = 0; i < t; ++i) r = __fsub_rn(r, bf16_round(r));
    return bf16_round(r);
}

// Stages rows [0, rows) of a (., W) bf16 matrix starting at `src` into a
// padded [TILE][LD] tile by cp.async; rows at or past `rows` are zeros.
template <int W, int LD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int rows) {
    constexpr int PIECES = W / 8;  // 16-byte pieces a row
    for (int e = threadIdx.x; e < TILE * PIECES; e += THREADS) {
        const int r = e / PIECES, k = (e - r * PIECES) * 8;
        const bool ok = r < rows;
        cp_async_16(dst + r * LD + k, src + (size_t)(ok ? r : 0) * W + k, ok);
    }
}

template <int N>
constexpr size_t chunk_state_smem(int q) {
    // B_j [TILE][N + 8] + the terms of w x, TERMS x [TILE][LDP] bf16, cum and w [q] float32
    return (size_t)(TILE * (N + 8) + TERMS * TILE * LDP) * sizeof(bf16) + 2 * (size_t)q * sizeof(float);
}

// Launch 1: grid BH x chunks, block (bh, c) = blockIdx.x / chunks, % chunks.
// Warp w owns state rows n in [w N/4, (w + 1) N/4) and all P columns.
template <int N>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_state(const bf16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const bf16* __restrict__ bmat,
                float* __restrict__ cum_out, float* __restrict__ states, int s, int q,
                int heads) {
    constexpr int LDN = N + 8;
    constexpr int MT = N / 64;  // 16-row m tiles of a warp
    extern __shared__ float4 smem4[];
    bf16* bs = reinterpret_cast<bf16*>(smem4);              // [TILE][LDN] B_j
    bf16* wt = bs + TILE * LDN;                             // TERMS x [TILE][LDP]: terms of w x_j
    float* cum = reinterpret_cast<float*>(wt + TERMS * TILE * LDP);  // [q]
    float* ws = cum + q;                                    // [q] dt, then w

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nc = s / q;
    const int c = blockIdx.x % nc;
    const int bh = blockIdx.x / nc;
    const size_t row0 = (size_t)bh * s + (size_t)c * q;                // first row of x and dt
    const size_t brow0 = (size_t)(bh / heads) * s + (size_t)c * q;    // first row of B
    const float av = a[bh];

    for (int t = tid; t < q; t += THREADS) {
        const float d = dt[row0 + t];
        ws[t] = d;
        cum[t] = __fmul_rn(d, av);
    }
    __syncthreads();
    if (warp == 0) {
        // inclusive cumsum by warp 0 in float64, each prefix rounded once, as
        // ssd_scan_fwd and the plain version do
        const int seg = (q + 31) / 32;
        const int lo = min(lane * seg, q), hi = min(lo + seg, q);
        double run = 0.0;
        for (int t = lo; t < hi; ++t) run += (double)cum[t];
        double incl = run;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const double v = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += v;
        }
        double pre = __shfl_up_sync(0xffffffffu, incl, 1);
        if (lane == 0) pre = 0.0;
        for (int t = lo; t < hi; ++t) {
            pre += (double)cum[t];
            cum[t] = __double2float_rn(pre);
        }
    }
    __syncthreads();
    for (int t = tid; t < q; t += THREADS) cum_out[row0 + t] = cum[t];
    if (c == nc - 1) return;  // nothing reads the state after the last chunk
    const float total = cum[q - 1];
    for (int t = tid; t < q; t += THREADS) {
        ws[t] = __fmul_rn(expf(__fsub_rn(total, cum[t])), ws[t]);
    }

    float acc[MT][8][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

    for (int j0 = 0; j0 < q; j0 += TILE) {
        const int rows = min(TILE, q - j0);
        __syncthreads();  // w is written; the previous tile's readers are done
        stage_rows<N, LDN>(bs, bmat + (brow0 + j0) * N, rows);
        for (int e = tid; e < TILE * (P / 8); e += THREADS) {
            const int r = e / (P / 8), k = (e - r * (P / 8)) * 8;
            float v[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i] = 0.f;
            if (r < rows) {
                const uint4 raw = *reinterpret_cast<const uint4*>(x + (row0 + j0 + r) * P + k);
                const bf16* xv = reinterpret_cast<const bf16*>(&raw);
                const float w = ws[j0 + r];
#pragma unroll
                for (int i = 0; i < 8; ++i) v[i] = __fmul_rn(__bfloat162float(xv[i]), w);
            }
#pragma unroll
            for (int t = 0; t < TERMS; ++t) {
                uint4 tv;
                uint32_t* w4 = reinterpret_cast<uint32_t*>(&tv);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float a0 = bf16_round(v[2 * i]), a1 = bf16_round(v[2 * i + 1]);
                    w4[i] = pack_bf16(a0, a1);
                    v[2 * i] = __fsub_rn(v[2 * i], a0);
                    v[2 * i + 1] = __fsub_rn(v[2 * i + 1], a1);
                }
                *reinterpret_cast<uint4*>(wt + t * TILE * LDP + r * LDP + k) = tv;
            }
        }
        cp_async_wait_all();
        __syncthreads();

        const int ksteps = (rows + 15) / 16;  // the zero rows past the chunk add nothing
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
            if (kk < ksteps) {
                // A = B_j^T (n x j): the B tile is [j][n], so .trans
                uint32_t af[MT][4];
#pragma unroll
                for (int m = 0; m < MT; ++m) {
                    ldmatrix_x4_trans(af[m], bs + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDN +
                                                 warp * (N / 4) + m * 16 + ((lane >> 3) & 1) * 8);
                }
#pragma unroll
                for (int np = 0; np < P / 16; ++np) {
                    // B = w x_j (j x p), stored [j][p]: .trans
                    const int off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDP + np * 16 +
                                    (lane >> 4) * 8;
#pragma unroll
                    for (int t = TERMS - 1; t >= 0; --t) {  // the smallest term first
                        uint32_t bt[4];
                        ldmatrix_x4_trans(bt, wt + t * TILE * LDP + off);
#pragma unroll
                        for (int m = 0; m < MT; ++m) {
                            mma_bf16_m16n8k16(acc[m][2 * np], af[m], bt[0], bt[1]);
                            mma_bf16_m16n8k16(acc[m][2 * np + 1], af[m], bt[2], bt[3]);
                        }
                    }
                }
            }
        }
    }

    float* out = states + ((size_t)bh * (nc - 1) + c) * N * P;
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
        const int n = warp * (N / 4) + m * 16 + g;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int p = j * 8 + 2 * t4;
            *reinterpret_cast<float2*>(out + (size_t)n * P + p) = make_float2(acc[m][j][0], acc[m][j][1]);
            *reinterpret_cast<float2*>(out + (size_t)(n + 8) * P + p) =
                make_float2(acc[m][j][2], acc[m][j][3]);
        }
    }
}

// Launch 2: thread i owns four consecutive (n, p) of one bh and walks the
// chunks in order.  `states` is (BH, chunks - 1, N P), `h` (BH, chunks, N P).
__global__ void __launch_bounds__(PASS_THREADS)
ssd_state_pass(const float4* __restrict__ states, const float* __restrict__ cum,
               float4* __restrict__ h, int bh_count, int s, int q, int np4) {
    const size_t i = (size_t)blockIdx.x * PASS_THREADS + threadIdx.x;
    if (i >= (size_t)bh_count * np4) return;
    const int bh = (int)(i / np4), e = (int)(i - (size_t)bh * np4);
    const int nc = s / q;
    const float4* sv = states + (size_t)bh * (nc - 1) * np4 + e;
    float4* hv = h + (size_t)bh * nc * np4 + e;
    const float* tot = cum + (size_t)bh * s + q - 1;  // chunk c's total at tot[c q]
    float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < nc; ++c) {
        hv[(size_t)c * np4] = run;
        if (c + 1 < nc) {
            const float et = expf(tot[(size_t)c * q]);
            const float4 v = sv[(size_t)c * np4];
            run.x = __fadd_rn(__fmul_rn(et, run.x), v.x);
            run.y = __fadd_rn(__fmul_rn(et, run.y), v.y);
            run.z = __fadd_rn(__fmul_rn(et, run.z), v.z);
            run.w = __fadd_rn(__fmul_rn(et, run.w), v.w);
        }
    }
}

template <int N>
constexpr size_t chunk_scan_smem() {
    // C_i [TILE][N + 8]; then B_j [TILE][N + 8] and x_j [TILE][LDP] during the
    // j loop, two terms of h, 2 x [N][LDP], at a time after it, in the same
    // space; cum_i, cum_j and dt_j [TILE] float32
    constexpr size_t loop = (size_t)(TILE * (N + 8) + TILE * LDP);
    constexpr size_t pair = (size_t)(2 * N * LDP);
    return (size_t)(TILE * (N + 8) + (loop > pair ? loop : pair)) * sizeof(bf16) +
           3 * TILE * sizeof(float);
}

// Launch 3: grid BH x chunks x tiles, flattened with the tile fastest (the
// tiles of one chunk share its h in L2) and the heaviest tile first.  Warp w
// owns rows [16 w, 16 w + 16) of the i tile and all P columns.
template <int N>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_scan(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ cum, const float* __restrict__ h,
               const bf16* __restrict__ bmat, const bf16* __restrict__ cmat,
               const float* __restrict__ dskip, bf16* __restrict__ y, int s, int q, int heads) {
    constexpr int LDN = N + 8;
    constexpr size_t loop = (size_t)(TILE * LDN + TILE * LDP);
    constexpr size_t pair = (size_t)(2 * N * LDP);
    extern __shared__ float4 smem4[];
    bf16* cs = reinterpret_cast<bf16*>(smem4);  // [TILE][LDN] C_i
    bf16* bs = cs + TILE * LDN;                 // [TILE][LDN] B_j   (j loop)
    bf16* xs = bs + TILE * LDN;                 // [TILE][LDP] x_j   (j loop)
    bf16* ht = bs;                              // 2 x [N][LDP] terms of h (after it)
    float* cum_i = reinterpret_cast<float*>(bs + (loop > pair ? loop : pair));  // [TILE]
    float* cum_j = cum_i + TILE;                // [TILE]
    float* dt_j = cum_j + TILE;                 // [TILE]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int nc = s / q;
    const int ntiles = (q + TILE - 1) / TILE;
    const int ib = ntiles - 1 - (int)(blockIdx.x % ntiles);
    const int rest = (int)(blockIdx.x / ntiles);
    const int c = rest % nc, bh = rest / nc;
    const int i0 = ib * TILE;
    const int irows = min(TILE, q - i0);
    const size_t row0 = (size_t)bh * s + (size_t)c * q;
    const size_t brow0 = (size_t)(bh / heads) * s + (size_t)c * q;
    const int wrow = warp * 16;  // the warp's first row in the tile
    const bool rows_live = wrow < irows;  // else every row of the warp is past the chunk

    stage_rows<N, LDN>(cs, cmat + (brow0 + i0) * N, irows);
    for (int t = tid; t < TILE; t += THREADS) cum_i[t] = t < irows ? cum[row0 + i0 + t] : 0.f;

    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    for (int jb = 0; jb <= ib; ++jb) {
        const int j0 = jb * TILE;
        const int jrows = min(TILE, q - j0);
        __syncthreads();  // the previous j tile's readers are done
        stage_rows<N, LDN>(bs, bmat + (brow0 + j0) * N, jrows);
        stage_rows<P, LDP>(xs, x + (row0 + j0) * P, jrows);
        for (int t = tid; t < TILE; t += THREADS) {
            cum_j[t] = t < jrows ? cum[row0 + j0 + t] : 0.f;
            dt_j[t] = t < jrows ? dt[row0 + j0 + t] : 0.f;
        }
        cp_async_wait_all();
        __syncthreads();
        if (!rows_live) continue;

        // 16-column groups of j that can hold a pair j <= i of this warp's rows
        const int jmax = min(jb == ib ? warp : TILE / 16 - 1, (jrows - 1) / 16);

        // C_i . B_j^T: A = C_i [i][n]; B operand = B_j^T, stored [j][n]
        float sc[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
        for (int k = 0; k < N / 16; ++k) {
            uint32_t af[4];
            ldmatrix_x4(af, cs + (wrow + (lane & 15)) * LDN + k * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int np = 0; np < TILE / 16; ++np) {
                if (np <= jmax) {
                    uint32_t bf[4];
                    ldmatrix_x4(bf, bs + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDN + k * 16 +
                                        ((lane >> 3) & 1) * 8);
                    mma_bf16_m16n8k16(sc[2 * np], af, bf[0], bf[1]);
                    mma_bf16_m16n8k16(sc[2 * np + 1], af, bf[2], bf[3]);
                }
            }
        }

        // the decay, in float32; the exponent above the diagonal is never taken
        const int ia = i0 + wrow + g, ib8 = ia + 8;
        const float ca = cum_i[wrow + g], cb = cum_i[wrow + g + 8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int jj = j * 8 + 2 * t4 + e;
                const int jg = j0 + jj;
                const float cj = cum_j[jj], dj = dt_j[jj];
                sc[j][e] = (jg <= ia && ia < q)
                               ? __fmul_rn(__fmul_rn(sc[j][e], expf(__fsub_rn(ca, cj))), dj)
                               : 0.f;
                sc[j][2 + e] = (jg <= ib8 && ib8 < q)
                                   ? __fmul_rn(__fmul_rn(sc[j][2 + e], expf(__fsub_rn(cb, cj))), dj)
                                   : 0.f;
            }
        }

        // scores . x_j: the scores as TERMS bf16 A words each; B operand = x_j,
        // stored [j][p]: .trans
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
            if (kk <= jmax) {
                // word w: tile 2 kk + w / 2, values 2 (w % 2) and 2 (w % 2) + 1
                uint32_t at[TERMS][4];
#pragma unroll
                for (int w = 0; w < 4; ++w) {
                    float v0 = sc[2 * kk + w / 2][2 * (w % 2)];
                    float v1 = sc[2 * kk + w / 2][2 * (w % 2) + 1];
#pragma unroll
                    for (int t = 0; t < TERMS; ++t) {
                        const float a0 = bf16_round(v0), a1 = bf16_round(v1);
                        at[t][w] = pack_bf16(a0, a1);
                        v0 = __fsub_rn(v0, a0);
                        v1 = __fsub_rn(v1, a1);
                    }
                }
#pragma unroll
                for (int np = 0; np < P / 16; ++np) {
                    uint32_t bx[4];
                    ldmatrix_x4_trans(bx, xs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDP +
                                              np * 16 + (lane >> 4) * 8);
#pragma unroll
                    for (int t = TERMS - 1; t >= 0; --t) {  // the smallest term first
                        mma_bf16_m16n8k16(acc[2 * np], at[t], bx[0], bx[1]);
                        mma_bf16_m16n8k16(acc[2 * np + 1], at[t], bx[2], bx[3]);
                    }
                }
            }
        }
    }

    // inter-chunk term C_i . h_c^T; h_0 is zero
    float inter[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) inter[j][e] = 0.f;
    if (c > 0) {
        const float4* hc = reinterpret_cast<const float4*>(h + ((size_t)bh * nc + c) * N * P);
        // the terms of h, two at a time in the space of B_j and x_j, the smallest first
#pragma unroll
        for (int t1 = TERMS - 1; t1 >= 0; t1 -= 2) {
            const int t0 = t1 - 1;  // the pass holds terms t1 and t0 (none if t0 < 0)
            __syncthreads();  // the j loop (or the previous pass) is done with this space
            for (int e = tid; e < N * P / 4; e += THREADS) {
                const float4 v = hc[e];
                const int r = (e * 4) / P, k = (e * 4) - r * P;
                const float f[4] = {v.x, v.y, v.z, v.w};
                float a[4], b[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    a[i] = term(f[i], t1);
                    b[i] = t0 >= 0 ? term(f[i], t0) : 0.f;
                }
                *reinterpret_cast<uint2*>(ht + r * LDP + k) =
                    make_uint2(pack_bf16(a[0], a[1]), pack_bf16(a[2], a[3]));
                *reinterpret_cast<uint2*>(ht + N * LDP + r * LDP + k) =
                    make_uint2(pack_bf16(b[0], b[1]), pack_bf16(b[2], b[3]));
            }
            __syncthreads();
            if (rows_live) {
#pragma unroll
                for (int k = 0; k < N / 16; ++k) {
                    uint32_t af[4];
                    ldmatrix_x4(af, cs + (wrow + (lane & 15)) * LDN + k * 16 + (lane >> 4) * 8);
#pragma unroll
                    for (int np = 0; np < P / 16; ++np) {
                        // B operand = h (n x p), stored [n][p]: .trans
                        const int off = (k * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDP +
                                        np * 16 + (lane >> 4) * 8;
                        uint32_t b1[4];
                        ldmatrix_x4_trans(b1, ht + off);
                        mma_bf16_m16n8k16(inter[2 * np], af, b1[0], b1[1]);
                        mma_bf16_m16n8k16(inter[2 * np + 1], af, b1[2], b1[3]);
                        if (t0 >= 0) {
                            uint32_t b0[4];
                            ldmatrix_x4_trans(b0, ht + N * LDP + off);
                            mma_bf16_m16n8k16(inter[2 * np], af, b0[0], b0[1]);
                            mma_bf16_m16n8k16(inter[2 * np + 1], af, b0[2], b0[3]);
                        }
                    }
                }
            }
        }
    }

    // out = (intra + exp(cum) inter) + D x, cast once
    const float dv = dskip[bh];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int r = wrow + g + 8 * half;
        const int i = i0 + r;
        if (i >= q) continue;
        const float ec = expf(cum_i[r]);
        const size_t at = (row0 + i) * P;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int p = j * 8 + 2 * t4;
            const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + at + p);
            const float y0 = __fadd_rn(__fadd_rn(acc[j][2 * half], __fmul_rn(ec, inter[j][2 * half])),
                                       __fmul_rn(dv, __bfloat162float(xv.x)));
            const float y1 =
                __fadd_rn(__fadd_rn(acc[j][2 * half + 1], __fmul_rn(ec, inter[j][2 * half + 1])),
                          __fmul_rn(dv, __bfloat162float(xv.y)));
            *reinterpret_cast<__nv_bfloat162*>(y + at + p) = __floats2bfloat162_rn(y0, y1);
        }
    }
}

bool takes(int n, int q, int s, int bh, int heads) {
    return (n == 64 || n == 128) && q >= 1 && q <= MAX_CHUNK && s % q == 0 && heads >= 1 &&
           bh >= 1 && bh % heads == 0;
}

template <int N>
cudaError_t chunk_state(const void* x, const void* dt, const void* a, const void* b, void* cum,
                        void* states, int bh, int s, int q, int heads, cudaStream_t stream) {
    auto kernel = ssd_chunk_state<N>;
    static std::atomic<unsigned long long> smem_devices{0};
    cudaError_t err = hopper::allow_smem(kernel, chunk_state_smem<N>(MAX_CHUNK), smem_devices);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)(bh * (s / q)), THREADS, chunk_state_smem<N>(q), stream>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
        static_cast<const bf16*>(b), static_cast<float*>(cum), static_cast<float*>(states), s, q,
        heads);
    return cudaGetLastError();
}

template <int N>
cudaError_t chunk_scan(const void* x, const void* dt, const void* cum, const void* h,
                       const void* b, const void* c, const void* d, void* y, int bh, int s, int q,
                       int heads, cudaStream_t stream) {
    auto kernel = ssd_chunk_scan<N>;
    constexpr size_t smem = chunk_scan_smem<N>();
    static std::atomic<unsigned long long> smem_devices{0};
    cudaError_t err = hopper::allow_smem(kernel, smem, smem_devices);
    if (err != cudaSuccess) return err;
    const unsigned blocks = (unsigned)bh * (unsigned)(s / q) * (unsigned)((q + TILE - 1) / TILE);
    kernel<<<blocks, THREADS, smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(cum),
        static_cast<const float*>(h), static_cast<const bf16*>(b), static_cast<const bf16*>(c),
        static_cast<const float*>(d), static_cast<bf16*>(y), s, q, heads);
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
// C 16-byte aligned.  Each returns a cudaError_t: 0 on success,
// cudaErrorInvalidValue for a state size, chunk or layout it does not take.
//
// Launch 1: cum (BH, S) and states (BH, S/q - 1, N, P), float32.
int ssd_chunk_state_launch(int n, const void* x, const void* dt, const void* a, const void* b,
                           void* cum, void* states, int bh, int s, int q, int heads,
                           void* stream) {
    if (!sp::takes(n, q, s, bh, heads) || (long long)bh * (s / q) >= (1ll << 31)) {
        return cudaErrorInvalidValue;
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return n == 64 ? sp::chunk_state<64>(x, dt, a, b, cum, states, bh, s, q, heads, st)
                   : sp::chunk_state<128>(x, dt, a, b, cum, states, bh, s, q, heads, st);
}

// Launch 2: from states and cum, h (BH, S/q, N, P) float32.
int ssd_state_pass_launch(int n, const void* states, const void* cum, void* h, int bh, int s,
                          int q, void* stream) {
    if (!sp::takes(n, q, s, bh, 1)) return cudaErrorInvalidValue;
    const long long threads = (long long)bh * n * sp::P / 4;
    const long long blocks = (threads + sp::PASS_THREADS - 1) / sp::PASS_THREADS;
    if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
    sp::ssd_state_pass<<<(unsigned)blocks, sp::PASS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(states), static_cast<const float*>(cum),
        static_cast<float4*>(h), bh, s, q, n * sp::P / 4);
    return cudaGetLastError();
}

// Launch 3: out (BH, S, P) bf16.
int ssd_chunk_scan_launch(int n, const void* x, const void* dt, const void* cum, const void* h,
                          const void* b, const void* c, const void* d, void* y, int bh, int s,
                          int q, int heads, void* stream) {
    if (!sp::takes(n, q, s, bh, heads) ||
        (long long)bh * (s / q) * ((q + sp::TILE - 1) / sp::TILE) >= (1ll << 31)) {
        return cudaErrorInvalidValue;
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return n == 64 ? sp::chunk_scan<64>(x, dt, cum, h, b, c, d, y, bh, s, q, heads, st)
                   : sp::chunk_scan<128>(x, dt, cum, h, b, c, d, y, bh, s, q, heads, st);
}

const char* ssd_scan_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
