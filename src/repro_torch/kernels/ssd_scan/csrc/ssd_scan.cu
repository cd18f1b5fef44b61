// Mamba2 SSD chunked scan for Hopper (sm_90a): x, B and C in float32 or
// bfloat16, dt, A and D in float32, everything computed in float32.
//
// Replaces the Pallas TPU kernel `ssd_scan_kernel` of
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
// b // heads), all contiguous.  One block of 256 threads owns one (batch,
// head) and walks its chunks in order; the loop takes the place of the TPU
// grid's sequential "arbitrary" chunk axis, and the (P, N) float32 state stays
// in shared memory from one chunk to the next.  A chunk of B and C in float32
// at Q = 256, N = 128 would be 128 KB each, so the chunk is cut into 64-row
// blocks: for each i block, C_i is staged once (transposed), and the j blocks
// j <= i are staged in turn (B_j transposed, x_j as is), as in a flash loop
// with a decay mask in place of the softmax.  A thread owns a 4 x 4 tile of
// the scores (rows 4ty.., columns tx + 16c) and 4 rows by P/16 columns of the
// output.  The last i block visits every j block, so the state update is
// accumulated there, in registers, and written after every i block has read
// the old state.  At P = 64, N = 128, Q = 256 the block holds 137 KB of
// dynamic shared memory, so one block runs on each SM.
//
// What bounds it: at the full-width scoring shape the work is about 34 MFLOP
// per (batch-head, chunk) against 0.1 MB moved, so the card's arithmetic, not
// its memory, is the limit.  This first version does all of it in float32 on
// the CUDA cores (67 TFLOP/s peak), reading its operands from shared memory,
// not on the tensor cores (989 TFLOP/s bf16).  wgmma for C.B^T, scores.x and
// the state products, TMA staging, and one C.B^T shared by the heads of a
// batch entry are for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
    // above 48 KB a block's shared memory must be asked for, on the current device
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16 (x, B, C and the output).  Returns a
// cudaError_t: 0 on success, cudaErrorInvalidValue for a head dim, state
// size, chunk or dtype that has no instance.
int ssd_scan_fwd_launch(int dtype, int p, const void* x, const void* dt, const void* a,
                        const void* b, const void* c, const void* d, void* y, int bh, int s,
                        int n, int q, int heads, void* stream) {
    if (n < 1 || n > MAX_N || q < 1 || q > MAX_CHUNK || s % q != 0 || heads < 1 ||
        bh % heads != 0) {
        return cudaErrorInvalidValue;
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch<float>(p, x, dt, a, b, c, d, y, bh, s, n, q, heads, st);
    if (dtype == 1) {
        return dispatch<__nv_bfloat16>(p, x, dt, a, b, c, d, y, bh, s, n, q, heads, st);
    }
    return cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
