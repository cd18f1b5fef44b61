// Forward flash attention for Hopper (sm_90a), float32 or bfloat16 in and out.
//
// Replaces the Pallas TPU kernel `flash_attention_kernel` of
// src/repro/kernels/flash_attention/kernel.py: online-softmax attention over
// key blocks with m, l and the output accumulator in float32, causal or
// bidirectional with a query offset, grouped-query attention through the
// index map bh // groups (no KV replication), blocks above the causal
// diagonal skipped, keys at or past seq_k masked with the finite -1e30, and
// the denominator max(l, 1e-37).  P.V is taken in float32 from an unrounded
// P, as in the Pallas body.
//
// Layout: q (BH, Sq, D), k and v (BH / groups, Sk, D), o (BH, Sq, D), all
// contiguous.  One block of 128 threads computes a tile of 64 query rows of
// one (batch, head) and walks the key blocks of 64 rows in order, which takes
// the place of the TPU's sequential "arbitrary" grid axis.  The tiles are
// staged in shared memory as float32: Q transposed (once), then K transposed
// and V in one buffer in turn, and P transposed.  Each thread owns 4 query
// rows and 8 key columns of the score tile, and the same 4 rows and D/8
// columns of the output; a row's 8 threads are neighbouring lanes of a warp,
// so the row max and sum are three shuffles.
//
// What bounds it: at the prefill shapes the work is 4*D multiply-adds per
// (query, key) pair against 2*D elements moved per row, so the card's
// arithmetic, not its memory, is the limit.  This first version does all of
// it in float32 on the CUDA cores (67 TFLOP/s peak), not on the tensor cores
// (989 TFLOP/s bf16), and stages through shared memory without cp.async or
// TMA; wgmma, TMA and a producer/consumer pipeline are for a later version.
// The causal q-blocks are launched heaviest first, so the blocks with the
// most key blocks do not form the tail of the grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // key rows per step
constexpr int THREADS = 128;    // 16 row groups of 4 rows x 8 column lanes
constexpr int LQ = BQ + 4;      // row length of the transposed tiles; keeps float4 alignment
constexpr float NEG_INF = -1e30f;

static_assert(BK == LQ - 4, "the transposed K tile shares the Q tile's row length");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
    // qt [D][LQ] + kv [D][LQ] (K^T, then V as [BK][D] <= D*LQ) + pt [BK][LQ]
    return (size_t)(2 * D * LQ + BK * LQ) * sizeof(float);
}

// Copy rows [row0, row0 + rows) of a (n, D) matrix into shared memory as
// float32, transposed to [D][LQ] when TRANSPOSE, else as [rows][D]; rows at or
// past n are zero, so a padded key contributes 0 * V and never a NaN.
template <typename T, int D, bool TRANSPOSE>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int row0, int n,
                                      int rows) {
    for (int i = threadIdx.x; i < rows * D; i += THREADS) {
        const int r = i / D, c = i - r * D;
        const float x = row0 + r < n ? to_f32(src[(size_t)(row0 + r) * D + c]) : 0.f;
        if (TRANSPOSE) {
            dst[c * LQ + r] = x;
        } else {
            dst[r * D + c] = x;
        }
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, int sq, int sk, int groups, int causal, int q_offset,
                    float sm_scale) {
    static_assert(D % 8 == 0 && D <= 128, "head dim must be a multiple of 8, at most 128");
    constexpr int DC = D / 8;  // output columns per thread
    extern __shared__ float4 smem4[];
    float* qt = reinterpret_cast<float*>(smem4);  // [D][LQ]
    float* kv = qt + D * LQ;                      // [D][LQ] K^T, then [BK][D] V
    float* pt = kv + D * LQ;                      // [BK][LQ] P^T

    const int tx = threadIdx.x & 7;   // key columns tx + 8j, output columns tx + 8j
    const int ty = threadIdx.x >> 3;  // query rows 4ty .. 4ty + 3
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal block first
    const int bh = blockIdx.y;
    const T* qp = q + (size_t)bh * sq * D;
    const T* kp = k + (size_t)(bh / groups) * sk * D;
    const T* vp = v + (size_t)(bh / groups) * sk * D;

    stage<T, D, true>(qt, qp, q0, sq, BQ);

    float m[4], l[4], acc[4][DC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
    }

    int nk = (sk + BK - 1) / BK;
    if (causal) {  // key blocks wholly above the diagonal are never visited
        const int last = q0 + BQ - 1 + q_offset;
        nk = min(nk, last / BK + 1);
    }

    for (int kb = 0; kb < nk; ++kb) {
        const int k0 = kb * BK;
        __syncthreads();  // the previous step is done with kv and pt
        stage<T, D, true>(kv, kp, k0, sk, BK);
        __syncthreads();

        float s[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
            const float4 a = *reinterpret_cast<const float4*>(&qt[d * LQ + 4 * ty]);
            const float* kr = &kv[d * LQ + tx];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float b = kr[8 * j];
                s[0][j] += a.x * b;
                s[1][j] += a.y * b;
                s[2][j] += a.z * b;
                s[3][j] += a.w * b;
            }
        }
        __syncthreads();  // every read of K^T is done before V takes its place
        stage<T, D, false>(kv, vp, k0, sk, BK);

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qpos = q0 + 4 * ty + i + q_offset;
            float mx = NEG_INF;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int kpos = k0 + tx + 8 * j;
                const bool keep = kpos < sk && (!causal || kpos <= qpos);
                s[i][j] = keep ? s[i][j] * sm_scale : NEG_INF;
                mx = fmaxf(mx, s[i][j]);
            }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
            const float m_new = fmaxf(m[i], mx);
            const float alpha = expf(m[i] - m_new);
            float rs = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                s[i][j] = expf(s[i][j] - m_new);
                rs += s[i][j];
            }
            rs += __shfl_xor_sync(0xffffffffu, rs, 1);
            rs += __shfl_xor_sync(0xffffffffu, rs, 2);
            rs += __shfl_xor_sync(0xffffffffu, rs, 4);
            l[i] = l[i] * alpha + rs;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            *reinterpret_cast<float4*>(&pt[(tx + 8 * j) * LQ + 4 * ty]) =
                make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        }
        __syncthreads();  // P^T and V are in place

#pragma unroll 4
        for (int c = 0; c < BK; ++c) {
            const float4 p = *reinterpret_cast<const float4*>(&pt[c * LQ + 4 * ty]);
            const float* vr = &kv[c * D + tx];
#pragma unroll
            for (int jj = 0; jj < DC; ++jj) {
                const float x = vr[8 * jj];
                acc[0][jj] += p.x * x;
                acc[1][jj] += p.y * x;
                acc[2][jj] += p.z * x;
                acc[3][jj] += p.w * x;
            }
        }
    }

    T* op = o + (size_t)bh * sq * D;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = q0 + 4 * ty + i;
        if (r >= sq) continue;
        const float denom = fmaxf(l[i], 1e-37f);
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) {
            op[(size_t)r * D + tx + 8 * jj] = from_f32<T>(acc[i][jj] / denom);
        }
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk,
                   int groups, int causal, int q_offset, float sm_scale, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<D>();
    auto kernel = flash_attention_fwd<T, D>;
    // above 48 KB a block's shared memory must be asked for, on the current device
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((sq + BQ - 1) / BQ, bh);
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), sq, sk, groups, causal, q_offset, sm_scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, void* o, int bh, int sq,
                     int sk, int groups, int causal, int q_offset, float sm_scale,
                     cudaStream_t stream) {
#define FA_CASE(DIM)                                                                        \
    case DIM:                                                                               \
        return launch<T, DIM>(q, k, v, o, bh, sq, sk, groups, causal, q_offset, sm_scale, \
                              stream);
    switch (d) {
        FA_CASE(16)
        FA_CASE(32)
        FA_CASE(64)
        FA_CASE(96)
        FA_CASE(112)
        FA_CASE(128)
        default:
            return cudaErrorInvalidValue;
    }
#undef FA_CASE
}

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16.  Returns a cudaError_t: 0 on success,
// cudaErrorInvalidValue for a head dim or dtype that has no instance.
int flash_attention_fwd_launch(int dtype, int d, const void* q, const void* k, const void* v,
                               void* o, int bh, int sq, int sk, int groups, int causal,
                               int q_offset, float sm_scale, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        return dispatch<float>(d, q, k, v, o, bh, sq, sk, groups, causal, q_offset, sm_scale, s);
    }
    if (dtype == 1) {
        return dispatch<__nv_bfloat16>(d, q, k, v, o, bh, sq, sk, groups, causal, q_offset,
                                       sm_scale, s);
    }
    return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
