// Forward flash attention for Hopper (sm_90a), in two instances.  Both
// replace the Pallas TPU kernel `flash_attention_kernel` of
// src/repro/kernels/flash_attention/kernel.py: online-softmax attention over
// key blocks with m, l and the output accumulator in float32, causal or
// bidirectional with a query offset, grouped-query attention through the
// index map bh // groups (no KV replication), blocks above the causal
// diagonal skipped, keys at or past seq_k masked with the finite -1e30, and
// the denominator max(l, 1e-37).
//
// Layout: q (BH, Sq, D), k and v (BH / groups, Sk, D), o (BH, Sq, D), all
// contiguous.  The wrapper picks the instance from (dtype, D) alone.
//
// 1. flash_attention_wgmma: bf16 at D in {64, 96, 112, 128, 224}, the head
//    dims of the repo's models (224: the published Zamba2's shared attention).  What bounds it: at the prefill shapes the work is 4*D
//    operations per (query, key) pair against 2*D elements moved per row,
//    so the tensor cores' bf16 rate (989 TFLOP/s), not the memory, is the
//    limit; the softmax's exponentials on the CUDA cores take about half as
//    long as the products, so they must run beside them.  The design:
//    - one block of three warpgroups per (bh, 128-query tile), the heaviest
//      causal tiles of every head launched first.  Warpgroup 0 is the
//      producer: it gives its registers up (setmaxnreg) and one thread
//      issues TMA loads.  Warpgroups 1 and 2 each own 64 query rows;
//    - TMA through 3-D tensor maps over (D, S, heads) with the 128-byte
//      swizzle: Q once, then K and V through a ring of three 128-key
//      stages, each with a full and an empty barrier for K and for V: a K
//      stage goes back to the producer once Q.K^T has read it, a V stage
//      once P.V has.  A row past seq_k (or a column past D = 96, 112 or
//      224) is out of the map's bounds and lands as zeros, so a padded key
//      adds 0 * V and never a NaN;
//    - S = Q.K^T on wgmma m64n128k16 from shared memory (K is (keys, D),
//      K-major), online softmax in registers on the accumulator's layout
//      (a row's max and sum take two shuffles within a quad; exp2 with
//      log2(e)/sqrt(D) folded into one multiply-add), l summing the float32
//      P.  Masks apply only on the diagonal and tail blocks, which run after
//      the others in a loop of their own: a runtime mask branch in the
//      softmax of every block cost a quarter of the kernel's time;
//    - O += P.V on wgmma with P from registers, rounded to bf16 (the one
//      change of arithmetic against the Pallas body, which keeps P in
//      float32; a TPU at JAX's default precision multiplies float32 in bf16
//      passes too), and V from shared memory with the transpose bit set
//      (V is (keys, D), MN-major).  D = 96 runs as 128 with zero columns;
//      D = 112 runs P.V as m64n112k16, which reads V's first 64-column
//      block and 48 columns of its second, and Q.K^T in 7 k-steps;
//    - D = 224 has tiles of its own (Dims<224>): at the tiles above, 128
//      keys of 256 columns, Q and three K/V stages would need 448 KB of
//      shared memory.  It takes 64-key stages, two deep: Q 64 KB + 2 x (K
//      32 KB + V 32 KB) = 192 KB.  S = Q.K^T runs on m64n64k16 in 14
//      k-steps, P.V on m64n224k16 (V's first three 64-column blocks and 32
//      columns of its fourth) in 4; the O accumulator is 112 registers a
//      consumer thread, S 32 and P 16, the 160 of D = 128.  With two stages,
//      the split empty barriers keep the next block's K and V loading under
//      the current block's products;
//    - overlap: a warpgroup issues Q.K^T of block kb + 1 together with P.V
//      of block kb and waits only for Q.K^T before its softmax, so P.V runs
//      under the exponentials; and the two consumer warpgroups take turns
//      to issue (named barriers), so one's products run during the other's
//      softmax;
//    - the output, divided by max(l, 1e-37) and rounded to bf16, goes
//      through the warpgroup's own rows of the Q tile to 16-byte stores.
//    At D = 96, 112 and 128 it holds 224 KB of shared memory: Q 32 KB +
//    3 x (K 32 KB + V 32 KB); at 224, 192 KB.  The softmax scale is the
//    caller's (1/sqrt(D) unless it gives another), folded with log2(e).
//
// 2. flash_attention_fwd: float32 at every head dim, and bf16 at D in
//    {16, 32}.  The tensor cores would take float32 only as TF32, which
//    misses float32's 2e-4 tolerance, so this instance computes in float32
//    on the CUDA cores (67 TFLOP/s peak), and P.V from an unrounded P as the
//    Pallas body does.  One block of 128 threads computes a tile of 64 query
//    rows of one (batch, head) and walks the key blocks of 64 rows in order,
//    which takes the place of the TPU's sequential "arbitrary" grid axis.
//    The tiles are staged in shared memory as float32: Q transposed (once),
//    then K transposed and V in one buffer in turn, and P transposed.  Each
//    thread owns 4 query rows and 8 key columns of the score tile, and the
//    same 4 rows and D/8 columns of the output; a row's 8 threads are
//    neighbouring lanes of a warp, so the row max and sum are three
//    shuffles.  It stages through shared memory without TMA, and its causal
//    q-blocks are launched heaviest first.

#include <stdio.h>

#include <atomic>
#include <type_traits>

#include "../../csrc/hopper.cuh"

namespace {

using hopper::allow_smem;

}  // namespace

// ------------------------------------------------------------------------
// 2. the CUDA-core instance
// ------------------------------------------------------------------------

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
    static std::atomic<unsigned long long> smem_devices{0};
    cudaError_t err = allow_smem(kernel, smem, smem_devices);
    if (err != cudaSuccess) return err;
    const dim3 grid((sq + BQ - 1) / BQ, bh);
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), sq, sk, groups, causal, q_offset, sm_scale);
    return cudaGetLastError();
}

#define FA_CASE(T, DIM)                                                                     \
    case DIM:                                                                               \
        return launch<T, DIM>(q, k, v, o, bh, sq, sk, groups, causal, q_offset, sm_scale, \
                              stream);

cudaError_t dispatch_f32(int d, const void* q, const void* k, const void* v, void* o, int bh,
                         int sq, int sk, int groups, int causal, int q_offset, float sm_scale,
                         cudaStream_t stream) {
    switch (d) {
        FA_CASE(float, 16)
        FA_CASE(float, 32)
        FA_CASE(float, 64)
        FA_CASE(float, 96)
        FA_CASE(float, 112)
        FA_CASE(float, 128)
        default:
            return cudaErrorInvalidValue;
    }
}

// bf16 at the head dims the wgmma instance does not take
cudaError_t dispatch_bf16(int d, const void* q, const void* k, const void* v, void* o, int bh,
                          int sq, int sk, int groups, int causal, int q_offset, float sm_scale,
                          cudaStream_t stream) {
    switch (d) {
        FA_CASE(__nv_bfloat16, 16)
        FA_CASE(__nv_bfloat16, 32)
        default:
            return cudaErrorInvalidValue;
    }
}
#undef FA_CASE

}  // namespace

// ------------------------------------------------------------------------
// 1. the bf16 wgmma instance
// ------------------------------------------------------------------------

namespace {
namespace wg {

using namespace hopper;

constexpr int BQ = 128;                     // query rows per block
constexpr int THREADS = 384;                // producer + two consumer warpgroups
constexpr int ROW_BYTES = 128;              // one 64-column block row, bf16
constexpr int BLOCK_BYTES = BQ * ROW_BYTES;  // one 64-column block of the Q tile
constexpr int MAX_STAGES = 3;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// DP: the head dim as the shared-memory tiles hold it (96 and 112 are held as
// 128, 224 as 256); BKV keys a K/V stage, STAGES stages
template <int D> struct Dims {
    static constexpr int DP = D <= 64 ? 64 : D <= 128 ? 128 : 256;
    static constexpr int NB = DP / 64;                  // 64-column blocks per tile
    static constexpr int BKV = D <= 128 ? 128 : 64;
    static constexpr int STAGES = D <= 128 ? 3 : 2;
    static constexpr int Q_TILE = NB * BLOCK_BYTES;
    static constexpr int KV_BLOCK = BKV * ROW_BYTES;    // one 64-column block of a K/V stage
    static constexpr int KV_TILE = NB * KV_BLOCK;
    static constexpr int KSTEPS = D / 16;                // k-steps of S = Q.K^T
    static constexpr int PV_STEPS = BKV / 16;            // k-steps of P.V
    // N of P.V, the output columns a warpgroup accumulates: 112 and 224 read
    // V's own columns (m64n112k16, m64n224k16), 96 takes the zero columns of
    // the 128-wide tile
    static constexpr int PV_N = D == 112 || D == 224 ? D : DP;
    static_assert(STAGES <= MAX_STAGES, "the barriers hold MAX_STAGES stages");
};

struct Barriers {
    uint64_t q_full;
    uint64_t k_full[MAX_STAGES];
    uint64_t v_full[MAX_STAGES];
    uint64_t k_empty[MAX_STAGES];
    uint64_t v_empty[MAX_STAGES];
};

template <int D>
constexpr size_t smem_bytes() {
    // Q + STAGES x (K + V), the barriers, and room to align the tiles to 1024 bytes
    using Dm = Dims<D>;
    return (size_t)Dm::Q_TILE + 2 * Dm::STAGES * Dm::KV_TILE + sizeof(Barriers) + 1024;
}

// Byte offset of bf16 element (row, col) in a Q tile laid out as hopper.cuh says.
__device__ __forceinline__ uint32_t swizzled(int row, int col) {
    return (col >> 6) * BLOCK_BYTES + row * ROW_BYTES +
           ((((col & 63) >> 3) ^ (row & 7)) << 4) + ((col & 7) << 1);
}

// 2^x with subnormal results flushed to 0 (one MUFU.EX2)
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q.K^T at the stage's width: 128 keys (m64n128k16) or 64 (m64n64k16)
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    wgmma_ss_m64n128k16(d, a, b, scale_d);
}

__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    wgmma_ss_m64n64k16<0>(d, a, b, scale_d);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_wgmma(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                      int sq, int sk, int groups, int causal, int q_offset, float scale_log2) {
    using Dm = Dims<D>;
    constexpr int NB = Dm::NB, BKV = Dm::BKV, STAGES = Dm::STAGES, PV_N = Dm::PV_N;
    constexpr int KV_TILE = Dm::KV_TILE, PV_STEPS = Dm::PV_STEPS;
    extern __shared__ uint8_t smem_raw[];
    // tiles on a 1024-byte boundary, as the 128-byte swizzle's atoms need
    const uint32_t pad = (1024 - (smem_addr(smem_raw) & 1023)) & 1023;
    uint8_t* sm = smem_raw + pad;
    uint8_t* sq_tile = sm;                               // Q, then this block's output
    uint8_t* sk_tile = sm + Dm::Q_TILE;                  // K stages
    uint8_t* sv_tile = sk_tile + STAGES * KV_TILE;       // V stages
    Barriers& bar = *reinterpret_cast<Barriers*>(sv_tile + STAGES * KV_TILE);

    const int bh = blockIdx.x;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
    int nk = (sk + BKV - 1) / BKV;
    if (causal) {  // key blocks wholly above the diagonal are never visited
        nk = min(nk, (min(q0 + BQ, sq) - 1 + q_offset) / BKV + 1);
    }

    if (threadIdx.x == 0) {
        mbar_init(&bar.q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&bar.k_full[s], 1);
            mbar_init(&bar.v_full[s], 1);
            mbar_init(&bar.k_empty[s], 2 * 128);  // every consumer thread arrives
            mbar_init(&bar.v_empty[s], 2 * 128);
        }
        mbar_fence_init();
    }
    __syncthreads();

    const int wgi = threadIdx.x / 128;
    if (wgi == 0) {
        // ------------------------------------------------------- producer
        setmaxnreg_dec<40>();
        if (threadIdx.x == 0) {
            tma_prefetch(&tm_q);
            tma_prefetch(&tm_k);
            tma_prefetch(&tm_v);
            const int kvh = bh / groups;
            mbar_arrive_expect_tx(&bar.q_full, Dm::Q_TILE);
            for (int b = 0; b < NB; ++b) {
                tma_load_3d(sq_tile + b * BLOCK_BYTES, &tm_q, &bar.q_full, 64 * b, q0, bh);
            }
            for (int kb = 0; kb < nk; ++kb) {
                const int s = kb % STAGES;
                const uint32_t parity = ((kb / STAGES) & 1) ^ 1;  // the first round passes
                mbar_wait(&bar.k_empty[s], parity);
                mbar_arrive_expect_tx(&bar.k_full[s], KV_TILE);
                for (int b = 0; b < NB; ++b) {
                    tma_load_3d(sk_tile + s * KV_TILE + b * Dm::KV_BLOCK, &tm_k, &bar.k_full[s],
                                64 * b, kb * BKV, kvh);
                }
                mbar_wait(&bar.v_empty[s], parity);
                mbar_arrive_expect_tx(&bar.v_full[s], KV_TILE);
                for (int b = 0; b < NB; ++b) {
                    tma_load_3d(sv_tile + s * KV_TILE + b * Dm::KV_BLOCK, &tm_v, &bar.v_full[s],
                                64 * b, kb * BKV, kvh);
                }
            }
        }
    } else {
        // ------------------------------------------------------- consumers
        setmaxnreg_inc<232>();
        const int c = wgi - 1;            // this warpgroup's 64 rows: [64c, 64c + 64)
        const int t = threadIdx.x % 128;
        const int warp = t / 32, lane = t % 32;
        const int row0 = 64 * c + 16 * warp + lane / 4;  // and row0 + 8
        const int qpos0 = q0 + row0 + q_offset;
        const int col0 = 2 * (lane % 4);  // accumulator columns col0 + 8j + {0, 1}

        float acc_s[BKV / 2];          // S: BKV keys
        float acc_o[PV_N / 2];         // O: PV_N columns
        uint32_t p_regs[PV_STEPS][4];  // P as bf16, the A operand of each k-step of P.V
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) acc_s[i] = 0.f;
#pragma unroll
        for (int i = 0; i < PV_N / 2; ++i) acc_o[i] = 0.f;
        float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // rows row0, row0 + 8

        const uint32_t q_base = smem_addr(sq_tile) + 64 * c * ROW_BYTES;

        // S = Q . K^T for key block kb, issued and committed, not waited for
        auto issue_qk = [&](int kb) {
            const int s = kb % STAGES;
            mbar_wait(&bar.k_full[s], (kb / STAGES) & 1);
            const uint32_t k_base = smem_addr(sk_tile + s * KV_TILE);
            fence_regs(acc_s);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < Dm::KSTEPS; ++kk) {
                const uint32_t step = (kk % 4) * 32;
                wgmma_qk(acc_s, make_desc_sw128(q_base + (kk / 4) * BLOCK_BYTES + step, 0, 1024),
                         make_desc_sw128(k_base + (kk / 4) * Dm::KV_BLOCK + step, 0, 1024), kk > 0);
            }
            wgmma_commit();
        };
        // after Q.K^T of key block kb has completed: its K stage goes back to the producer
        auto qk_done = [&](int kb) { mbar_arrive(&bar.k_empty[kb % STAGES]); };
        // O += P . V for key block kb, from p_regs, issued and committed
        auto issue_pv = [&](int kb) {
            const int s = kb % STAGES;
            mbar_wait(&bar.v_full[s], (kb / STAGES) & 1);
            const uint32_t v_base = smem_addr(sv_tile + s * KV_TILE);
            fence_regs(acc_o);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < PV_STEPS; ++kk) {
                wgmma_rs(acc_o, p_regs[kk],
                         make_desc_sw128(v_base + kk * 16 * ROW_BYTES, Dm::KV_BLOCK, 1024), 1);
            }
            wgmma_commit();
        };
        // after P.V of key block kb has completed: its V stage goes back to the producer
        auto pv_done = [&](int kb) {
            fence_regs(acc_o);
#pragma unroll
            for (int kk = 0; kk < PV_STEPS; ++kk) {
#pragma unroll
                for (int w = 0; w < 4; ++w) asm volatile("" : "+r"(p_regs[kk][w])::"memory");
            }
            mbar_arrive(&bar.v_empty[kb % STAGES]);
        };
        // online softmax of key block kb on the accumulator's layout: acc_s[4j + e]
        // is row row0 + 8 * (e >= 2), key k0 + 8j + col0 + (e & 1).  Leaves P (float32)
        // in acc_s, and the rows' rescaling factors in alpha0, alpha1.  `mask`
        // (std::true_type or std::false_type) says whether the block holds keys
        // at or past seq_k or above the diagonal: a mask branch left in the
        // code of the other blocks costs a quarter of the kernel's time.
        float alpha0, alpha1;
        auto softmax = [&](int kb, auto mask) {
            const int k0 = kb * BKV;
            float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
            for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float x = acc_s[4 * j + e];
                    if constexpr (decltype(mask)::value) {
                        const int kpos = k0 + 8 * j + col0 + (e & 1);
                        const int qpos = qpos0 + ((e & 2) ? 8 : 0);
                        if (kpos >= sk || (causal && kpos > qpos)) x = NEG_INF;
                        acc_s[4 * j + e] = x;
                    }
                    if (e & 2) {
                        mx1 = fmaxf(mx1, x);
                    } else {
                        mx0 = fmaxf(mx0, x);
                    }
                }
            }
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
            // the scale is positive, so the scaled row max is the max of the scaled scores
            const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
            alpha0 = exp2_approx(m0 - mn0);
            alpha1 = exp2_approx(m1 - mn1);
            m0 = mn0;
            m1 = mn1;
            float rs0 = 0.f, rs1 = 0.f;  // this thread's share of the row sums
#pragma unroll
            for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float p =
                        exp2_approx(fmaf(acc_s[4 * j + e], scale_log2, (e & 2) ? -mn1 : -mn0));
                    acc_s[4 * j + e] = p;
                    if (e & 2) {
                        rs1 += p;
                    } else {
                        rs0 += p;
                    }
                }
            }
            l0 = l0 * alpha0 + rs0;  // summed over the quad at the end
            l1 = l1 * alpha1 + rs1;
        };
        // rescale O to the new row maxima, and round P to bf16: the accumulator
        // of keys [16kk, 16kk + 16) is the A operand of k-step kk of P.V
        auto rescale_and_pack = [&]() {
#pragma unroll
            for (int i = 0; i < PV_N / 2; ++i) acc_o[i] *= (i & 2) ? alpha1 : alpha0;
#pragma unroll
            for (int kk = 0; kk < PV_STEPS; ++kk) {
#pragma unroll
                for (int w = 0; w < 4; ++w) {
                    p_regs[kk][w] = pack_bf16(acc_s[8 * kk + 2 * w], acc_s[8 * kk + 2 * w + 1]);
                }
            }
        };

        // Block kb's P.V runs on the tensor cores while block kb + 1's softmax
        // runs on the CUDA cores: Q.K^T of kb + 1 and P.V of kb are issued
        // together, and only Q.K^T is waited for before the softmax.  The two
        // consumer warpgroups take turns to issue (barriers 3 and 4), so one's
        // products run while the other computes its softmax.
        auto my_turn = [&]() { named_barrier(3 + c, 256); };
        auto your_turn = [&]() { named_barrier_arrive(3 + (c ^ 1), 256); };
        auto step = [&](int kb, auto mask) {
            my_turn();
            issue_qk(kb);
            issue_pv(kb - 1);
            your_turn();
            wgmma_wait<1>();  // Q.K^T of kb is done, P.V of kb - 1 may still run
            fence_regs(acc_s);
            qk_done(kb);
            softmax(kb, mask);
            wgmma_wait<0>();
            pv_done(kb - 1);
            rescale_and_pack();
        };
        // blocks [0, unmasked) need no mask: every key is before seq_k and at
        // or below the diagonal of the tile's first query row.  The bound is
        // the tile's, not the warpgroup's, so it is the same in every thread.
        int unmasked = sk / BKV;
        if (causal) unmasked = min(unmasked, (q0 + q_offset + 1) / BKV);
        if (c == 1) your_turn();  // warpgroup 1 (c = 0) goes first
        mbar_wait(&bar.q_full, 0);
        my_turn();
        issue_qk(0);
        your_turn();
        wgmma_wait<0>();
        fence_regs(acc_s);
        qk_done(0);
        if (unmasked > 0) {
            softmax(0, std::false_type{});
        } else {
            softmax(0, std::true_type{});
        }
        rescale_and_pack();
        int kb = 1;
        for (; kb < unmasked; ++kb) step(kb, std::false_type{});
        for (; kb < nk; ++kb) step(kb, std::true_type{});
        my_turn();
        issue_pv(nk - 1);
        your_turn();
        wgmma_wait<0>();
        pv_done(nk - 1);
        if (c == 0) my_turn();  // take the turn warpgroup 2 handed over last

        // epilogue: O / max(l, 1e-37) in bf16, through this warpgroup's rows of the Q tile
        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        const float d0 = fmaxf(l0, 1e-37f), d1 = fmaxf(l1, 1e-37f);
#pragma unroll
        for (int j = 0; j < PV_N / 8; ++j) {
            const int col = 8 * j + col0;
            *reinterpret_cast<uint32_t*>(sq_tile + swizzled(row0, col)) =
                pack_bf16(acc_o[4 * j] / d0, acc_o[4 * j + 1] / d0);
            *reinterpret_cast<uint32_t*>(sq_tile + swizzled(row0 + 8, col)) =
                pack_bf16(acc_o[4 * j + 2] / d1, acc_o[4 * j + 3] / d1);
        }
        named_barrier(1 + c, 128);
        constexpr int CHUNKS = PV_N / 8;  // 16-byte chunks per row
        __nv_bfloat16* op = o + (size_t)bh * sq * D;
#pragma unroll 4
        for (int idx = t; idx < 64 * CHUNKS; idx += 128) {
            const int r = 64 * c + idx / CHUNKS, g = idx % CHUNKS;
            if (q0 + r < sq && 8 * g < D) {
                *reinterpret_cast<uint4*>(op + (size_t)(q0 + r) * D + 8 * g) =
                    *reinterpret_cast<const uint4*>(sq_tile + swizzled(r, 8 * g));
            }
        }
    }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk,
                   int groups, int causal, int q_offset, float sm_scale, cudaStream_t stream,
                   int* encode_err) {
    CUtensorMap tm_q, tm_k, tm_v;
    const int bk = bh / groups;
    int err = encode_bf16_3d(&tm_q, q, D, sq, bh, BQ);
    if (err == 0) err = encode_bf16_3d(&tm_k, k, D, sk, bk, Dims<D>::BKV);
    if (err == 0) err = encode_bf16_3d(&tm_v, v, D, sk, bk, Dims<D>::BKV);
    if (err != 0) {
        *encode_err = err;
        return cudaErrorInvalidValue;
    }
    constexpr size_t smem = smem_bytes<D>();
    auto kernel = flash_attention_wgmma<D>;
    static std::atomic<unsigned long long> smem_devices{0};
    cudaError_t cerr = allow_smem(kernel, smem, smem_devices);
    if (cerr != cudaSuccess) return cerr;
    const dim3 grid(bh, (sq + BQ - 1) / BQ);
    kernel<<<grid, THREADS, smem, stream>>>(tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), sq,
                                            sk, groups, causal, q_offset, sm_scale * LOG2E);
    return cudaGetLastError();
}

}  // namespace wg
}  // namespace

extern "C" {

// The CUDA-core instance.  dtype 0 = float32, 1 = bfloat16.  Returns a
// cudaError_t: 0 on success, cudaErrorInvalidValue for a (dtype, head dim)
// that this instance does not take (bf16 at 64, 96, 112 and 128 is the wgmma
// instance's).
int flash_attention_fwd_launch(int dtype, int d, const void* q, const void* k, const void* v,
                               void* o, int bh, int sq, int sk, int groups, int causal,
                               int q_offset, float sm_scale, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        return dispatch_f32(d, q, k, v, o, bh, sq, sk, groups, causal, q_offset, sm_scale, s);
    }
    if (dtype == 1) {
        return dispatch_bf16(d, q, k, v, o, bh, sq, sk, groups, causal, q_offset, sm_scale, s);
    }
    return cudaErrorInvalidValue;
}

// The bf16 wgmma instance, D in {64, 96, 112, 128, 224}; q, k and v 16-byte aligned;
// the scores scaled by sm_scale (positive).
// Returns 0, a cudaError_t, or hopper::ENCODE_ERROR_BASE + the CUresult of a
// tensor-map encode that failed.
int flash_attention_wgmma_launch(int d, const void* q, const void* k, const void* v, void* o,
                                 int bh, int sq, int sk, int groups, int causal, int q_offset,
                                 float sm_scale, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int encode_err = 0;
    cudaError_t err;
    switch (d) {
        case 64:
            err = wg::launch<64>(q, k, v, o, bh, sq, sk, groups, causal, q_offset, sm_scale, s,
                                 &encode_err);
            break;
        case 96:
            err = wg::launch<96>(q, k, v, o, bh, sq, sk, groups, causal, q_offset, sm_scale, s,
                                 &encode_err);
            break;
        case 112:
            err = wg::launch<112>(q, k, v, o, bh, sq, sk, groups, causal, q_offset, sm_scale, s,
                                  &encode_err);
            break;
        case 128:
            err = wg::launch<128>(q, k, v, o, bh, sq, sk, groups, causal, q_offset, sm_scale, s,
                                  &encode_err);
            break;
        case 224:
            err = wg::launch<224>(q, k, v, o, bh, sq, sk, groups, causal, q_offset, sm_scale, s,
                                  &encode_err);
            break;
        default:
            return cudaErrorInvalidValue;
    }
    return encode_err != 0 ? encode_err : (int)err;
}

const char* flash_attention_error_string(int err) {
    if (err >= hopper::ENCODE_ERROR_BASE) {
        static thread_local char msg[96];
        snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed with CUresult %d",
                 err - hopper::ENCODE_ERROR_BASE);
        return msg;
    }
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
