// RMSNorm over groups of channels, with an optional gate, for Hopper
// (sm_90a), with a plain C interface for ctypes:
//
//     g = x                  (no gate)
//     g = x * silu(z)        (gate z)
//     out[r, j W + c] = rms_norm(g[r, j W : (j + 1) W]) * scale[j W + c]
//
// x, z and out (rows, G W), scale (G W,), all contiguous and of one type
// (float32 or bf16); each row splits into G groups of W channels, W a
// multiple of 8, and each group is normalised over its own W channels.  G = 1
// is the plain norm of every layer; the gate is the Mamba2 mixer's output
// norm (rms_norm(y * silu(z)), G = ngroups).  The plain version of both, on
// the wrapper's signature, is ../ref.py (rms_norm(x, scale, eps, z, groups)).
//
// It replaces no TPU kernel: the JAX package normalises with jnp
// (src/repro/models/ops.py, rms_norm) and leaves the fusion to XLA.  It was
// added because the plain PyTorch version (../ref.py, rms_norm) is six
// passes over HBM (upcast, square, mean, rsqrt product, cast, scale),
// eight with the gate, and the norms were the largest stages of scoring on
// the card: 43 % of mamba2-370m's time at 10-13x their byte bound.
//
// Bound: HBM bytes.  Each input element is read once and each output element
// written once, with a few float operations between (an exponential and a
// division for the gate), far below the card's ridge.  At mamba2-370m's
// scoring shape one gated norm (x, z and out 256 x 2048 x 2048 bf16) moves
// 6.44 GB, 1.92 ms at 3.35 TB/s; one plain norm (256 x 2048 x 1024) 2.15 GB.
//
// Design: move each byte once, in 16-byte accesses, and hold the group on
// chip between its sum and its output.  `lanes` threads (a multiple of 32,
// at most a block) share a group; thread t owns the group's 16-byte vectors
// t, t + lanes, t + 2 lanes, ..., so a warp reads and writes 512 contiguous
// bytes an access.  A thread holds up to kHeld = 8 vectors (64 bf16 or 32
// float32 values) in registers, packed in the working type: the host takes
// the fewest warps that hold the group, one warp a group up to 2048 bf16
// channels (1024 float32) and a few above (W = 3584 bf16: 2 warps, 7
// vectors a thread), kBlock / lanes groups a block.  A thread issues every
// load of its vectors (x and z) before it computes anything, then gates,
// squares and sums them; the group's sum goes through warp shuffles and,
// for a group of several warps, shared memory (one barrier), each thread
// adding the warps' partial sums in the same order.  A group wider than the
// registers of kBlock threads hold (more than 16384 bf16 or 8192 float32
// channels) reads its remaining vectors twice, for the sum and for the
// output.  The scale is read with the output, from L1/L2.
//
// Rounding is the plain version's, so that the kernel differs from it only
// by the order of the float32 sum: silu(z) = z / (1 + expf(-z)) in float32
// (IEEE division and expf, no fast math), rounded to the working type, and
// x * silu(z) rounded; each square rounded (__fmul_rn: no fused
// multiply-add) and summed in float32; the mean as the sum times 1 / W in
// float32 (ATen's mean on the card multiplies by its factor); rsqrtf(var +
// eps), the function ATen's rsqrt calls on the card; g * r rounded to the
// working type, then times the scale, rounded.
//
// Each entry point launches on the caller's stream and the calling thread's
// current device (the caller makes it the tensors' device), does not
// synchronise, allocates nothing and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // threads a block at most
constexpr int kHeld = 8;     // 16-byte vectors a thread holds in registers
constexpr int kWidthMultiple = 8;

// values of one 16-byte vector
template <typename T>
struct Vec;
template <>
struct Vec<float> { static constexpr int n = 4; };
template <>
struct Vec<__nv_bfloat16> { static constexpr int n = 8; };

// the two bf16 halves of a 32-bit word as floats: the low one shifted up,
// the high one masked (one instruction each)
__device__ __forceinline__ float low_half(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float high_half(unsigned u) { return __uint_as_float(u & 0xFFFF0000u); }

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // rounds each to nearest even
  return *reinterpret_cast<const unsigned*>(&h);
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& w, float (&v)[Vec<T>::n]);

template <>
__device__ __forceinline__ void unpack<float>(const uint4& w, float (&v)[4]) {
  v[0] = __uint_as_float(w.x);
  v[1] = __uint_as_float(w.y);
  v[2] = __uint_as_float(w.z);
  v[3] = __uint_as_float(w.w);
}

template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& w, float (&v)[8]) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = low_half(u[i]);
    v[2 * i + 1] = high_half(u[i]);
  }
}

// the values rounded to T, packed
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}

__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                    pack_bf16(v[6], v[7]));
}

// v rounded to T and back: the value a T tensor would hold
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// x * silu(z), each factor and the product rounded to T
template <typename T>
__device__ __forceinline__ uint4 gate(const uint4& xw, const uint4& zw) {
  constexpr int n = Vec<T>::n;
  float x[n], z[n];
  unpack<T>(xw, x);
  unpack<T>(zw, z);
#pragma unroll
  for (int i = 0; i < n; ++i) x[i] *= round_to<T>(z[i] / (1.0f + expf(-z[i])));
  return pack(x);
}

// vector i of x, gated by vector i of z
template <typename T, bool kGate>
__device__ __forceinline__ uint4 load_gated(const uint4* xv, const uint4* zv, int i) {
  if constexpr (kGate) return gate<T>(__ldg(xv + i), __ldg(zv + i));
  return __ldg(xv + i);
}

// the sum of the vector's rounded squares
template <typename T>
__device__ __forceinline__ float squares(const uint4& w) {
  constexpr int n = Vec<T>::n;
  float v[n];
  unpack<T>(w, v);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < n; ++i) s += __fmul_rn(v[i], v[i]);
  return s;
}

// g * r rounded to T, times the scale, rounded
template <typename T>
__device__ __forceinline__ uint4 normalise(const uint4& gw, float r, const uint4& sw) {
  constexpr int n = Vec<T>::n;
  float g[n], s[n];
  unpack<T>(gw, g);
  unpack<T>(sw, s);
#pragma unroll
  for (int i = 0; i < n; ++i) g[i] = round_to<T>(g[i] * r) * s[i];
  return pack(g);
}

// The sum of v over the `lanes` threads of each group, in every thread of
// the group: warp shuffles, then the group's warps' partial sums through
// shared memory, added in warp order.  Every thread of the block calls it.
__device__ __forceinline__ float group_sum(float v, int lanes) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lanes == 32) return v;  // the same in every thread of the block
  __shared__ float part[kBlock / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  const int warps = lanes >> 5;
  const int first = static_cast<int>(threadIdx.x) / lanes * warps;
  float s = 0.f;
  for (int w = 0; w < warps; ++w) s += part[first + w];
  return s;
}

template <typename T, bool kGate>
__global__ void __launch_bounds__(kBlock)
rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ z, const T* __restrict__ scale,
                T* __restrict__ out, int64_t n_groups, int groups, int width, int lanes,
                float eps) {
  const int vecs = width / Vec<T>::n;  // 16-byte vectors of a group
  const int slot = static_cast<int>(threadIdx.x) / lanes;
  const int t = static_cast<int>(threadIdx.x) - slot * lanes;
  const int64_t grp = static_cast<int64_t>(blockIdx.x) * (blockDim.x / lanes) + slot;
  const bool live = grp < n_groups;  // a dead thread still takes part in the sum
  const int64_t start = grp * width;
  const uint4* xv = reinterpret_cast<const uint4*>(x + start);
  const uint4* zv = reinterpret_cast<const uint4*>(z + start);

  uint4 held[kHeld];
  float ss = 0.f;
  if (live) {
    uint4 zh[kHeld];
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {  // every load before any arithmetic
      const int i = t + k * lanes;
      if (i < vecs) {
        held[k] = __ldg(xv + i);
        if constexpr (kGate) zh[k] = __ldg(zv + i);
      }
    }
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      const int i = t + k * lanes;
      if (i < vecs) {
        if constexpr (kGate) held[k] = gate<T>(held[k], zh[k]);
        ss += squares<T>(held[k]);
      }
    }
    for (int i = t + kHeld * lanes; i < vecs; i += lanes) {  // beyond the registers
      ss += squares<T>(load_gated<T, kGate>(xv, zv, i));
    }
  }
  ss = group_sum(ss, lanes);
  if (!live) return;
  // the mean and var + eps each rounded, as two ATen kernels round them
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.0f / static_cast<float>(width)), eps));
  const uint4* sv = reinterpret_cast<const uint4*>(scale + (grp % groups) * width);
  uint4* ov = reinterpret_cast<uint4*>(out + start);
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    const int i = t + k * lanes;
    if (i < vecs) ov[i] = normalise<T>(held[k], r, __ldg(sv + i));
  }
  for (int i = t + kHeld * lanes; i < vecs; i += lanes) {  // read again
    ov[i] = normalise<T>(load_gated<T, kGate>(xv, zv, i), r, __ldg(sv + i));
  }
}

// threads a group: the fewest warps whose registers hold its vectors, at most a block
template <typename T>
int lanes_for(int64_t width) {
  const int64_t vecs = width / Vec<T>::n;
  const int64_t warps = (vecs + 32 * kHeld - 1) / (32 * kHeld);
  return static_cast<int>(warps < kBlock / 32 ? 32 * warps : kBlock);
}

template <typename T>
cudaError_t launch(const void* x, const void* z, const void* scale, void* out, int64_t rows,
                   int groups, int64_t width, float eps, cudaStream_t st) {
  const int lanes = lanes_for<T>(width);
  const int per_block = kBlock / lanes;
  const int64_t n_groups = rows * groups;
  const int64_t blocks = (n_groups + per_block - 1) / per_block;
  if (blocks > 2147483647) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* zt = static_cast<const T*>(z);
  const T* sc = static_cast<const T*>(scale);
  T* ot = static_cast<T*>(out);
  const dim3 grid(static_cast<unsigned>(blocks));
  const int threads = per_block * lanes;
  const int w = static_cast<int>(width);
  if (z != nullptr) {
    rms_norm_kernel<T, true><<<grid, threads, 0, st>>>(xt, zt, sc, ot, n_groups, groups, w,
                                                       lanes, eps);
  } else {
    rms_norm_kernel<T, false><<<grid, threads, 0, st>>>(xt, zt, sc, ot, n_groups, groups, w,
                                                        lanes, eps);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 float32, 1 bf16; x, z (or null: no gate) and out (rows, groups *
// width), scale (groups * width,), contiguous and 16-byte aligned, width a
// multiple of 8
int rms_norm_launch(int dtype, const void* x, const void* z, const void* scale, void* out,
                    int64_t rows, int groups, int64_t width, float eps, void* stream) {
  if (rows < 1 || groups < 1 || width < kWidthMultiple || width % kWidthMultiple ||
      width > 2147483647 / groups) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(x, z, scale, out, rows, groups, width, eps, st));
    case 1:
      return static_cast<int>(
          launch<__nv_bfloat16>(x, z, scale, out, rows, groups, width, eps, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* rms_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
