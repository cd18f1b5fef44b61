// GRIB simple packing on Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/grib_pack/kernel.py:
//   grib_pack_kernel   <- _pack_kernel   (codes = clip(rint((x - ref) * inv_scale), 0, maxcode))
//   grib_unpack_kernel <- _unpack_kernel (x = codes * scale + ref)
//
// Bound: HBM bytes.  Each kernel reads 4 B and writes 4 B per value and does
// three or four float operations on it, about 0.5 flop/B, far below the
// H100's ridge, so the time can only be the bytes over the memory rate.
// The design does what moves bytes fastest and nothing else: each thread
// moves 16 B per load and per store (float4/int4) where a field's H*W is a
// multiple of 4 and the pointers are 16-byte aligned, every block streams a
// contiguous stretch of one field with a grid stride, and the per-field
// scalars (ref, inv_scale or scale) are read once per block.  No shared
// memory, no tensor cores.  Fusing the min/max pass, writing the narrow
// uint8/uint16 container and reading it back in unpack would cut the bytes
// and are left for later.
//
// Rounding is pinned so that the kernels equal the plain PyTorch version bit
// for bit: the subtraction and the multiplication round apart (__fsub_rn,
// __fmul_rn, never an FMA), rintf rounds half to even like jnp.round, and
// __float2int_rn saturates, so the 2^31 clip bound of nbits=31 becomes
// INT32_MAX as in XLA.  Unpack multiplies and adds with __fmul_rn/__fadd_rn,
// because nvcc would otherwise contract them into one FMA.
//
// Each entry point launches on the caller's stream and the calling thread's
// current device (the caller makes it the tensors' device), does not
// synchronise, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// vectors (or scalars) each thread handles, which sets the blocks per field
constexpr int64_t kUnitsPerThread = 8;
constexpr int64_t kMaxGridX = 2147483647;
constexpr int64_t kMaxGridY = 65535;

__device__ __forceinline__ int32_t pack_one(float x, float ref, float inv_scale, float maxcode) {
  float v = rintf(__fmul_rn(__fsub_rn(x, ref), inv_scale));
  v = fminf(fmaxf(v, 0.0f), maxcode);
  return __float2int_rn(v);
}

__device__ __forceinline__ float unpack_one(int32_t c, float ref, float scale) {
  return __fadd_rn(__fmul_rn(__int2float_rn(c), scale), ref);
}

// grid: x = blocks within one field, y = field (looped when F > 65535)
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
grib_pack_kernel(const float* __restrict__ x, const float* __restrict__ ref,
                 const float* __restrict__ inv_scale, int32_t* __restrict__ codes,
                 int64_t n_fields, int64_t field_size, float maxcode) {
  const int64_t start = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t f = blockIdx.y; f < n_fields; f += gridDim.y) {
    const float r = ref[f];
    const float s = inv_scale[f];
    const int64_t base = f * field_size;
    if constexpr (kVec) {
      const float4* xv = reinterpret_cast<const float4*>(x + base);
      int4* cv = reinterpret_cast<int4*>(codes + base);
      const int64_t n4 = field_size / 4;
      for (int64_t i = start; i < n4; i += stride) {
        const float4 v = xv[i];
        int4 c;
        c.x = pack_one(v.x, r, s, maxcode);
        c.y = pack_one(v.y, r, s, maxcode);
        c.z = pack_one(v.z, r, s, maxcode);
        c.w = pack_one(v.w, r, s, maxcode);
        cv[i] = c;
      }
    } else {
      for (int64_t i = start; i < field_size; i += stride) {
        codes[base + i] = pack_one(x[base + i], r, s, maxcode);
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
grib_unpack_kernel(const int32_t* __restrict__ codes, const float* __restrict__ ref,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int64_t n_fields, int64_t field_size) {
  const int64_t start = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t f = blockIdx.y; f < n_fields; f += gridDim.y) {
    const float r = ref[f];
    const float s = scale[f];
    const int64_t base = f * field_size;
    if constexpr (kVec) {
      const int4* cv = reinterpret_cast<const int4*>(codes + base);
      float4* ov = reinterpret_cast<float4*>(out + base);
      const int64_t n4 = field_size / 4;
      for (int64_t i = start; i < n4; i += stride) {
        const int4 c = cv[i];
        float4 v;
        v.x = unpack_one(c.x, r, s);
        v.y = unpack_one(c.y, r, s);
        v.z = unpack_one(c.z, r, s);
        v.w = unpack_one(c.w, r, s);
        ov[i] = v;
      }
    } else {
      for (int64_t i = start; i < field_size; i += stride) {
        out[base + i] = unpack_one(codes[base + i], r, s);
      }
    }
  }
}

dim3 grid_for(int64_t n_fields, int64_t units_per_field) {
  const int64_t per_block = kThreads * kUnitsPerThread;
  int64_t bx = (units_per_field + per_block - 1) / per_block;
  bx = bx < 1 ? 1 : (bx > kMaxGridX ? kMaxGridX : bx);
  const int64_t by = n_fields > kMaxGridY ? kMaxGridY : n_fields;
  return dim3(static_cast<unsigned>(bx), static_cast<unsigned>(by), 1);
}

}  // namespace

extern "C" {

// codes[f, i] = clip(rint((x[f, i] - ref[f]) * inv_scale[f]), 0, maxcode); vec != 0
// requires field_size % 4 == 0 and 16-byte aligned x and codes
int grib_pack_f32(const float* x, const float* ref, const float* inv_scale, int32_t* codes,
                  int64_t n_fields, int64_t field_size, float maxcode, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    grib_pack_kernel<true><<<grid_for(n_fields, field_size / 4), kThreads, 0, st>>>(
        x, ref, inv_scale, codes, n_fields, field_size, maxcode);
  } else {
    grib_pack_kernel<false><<<grid_for(n_fields, field_size), kThreads, 0, st>>>(
        x, ref, inv_scale, codes, n_fields, field_size, maxcode);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[f, i] = codes[f, i] * scale[f] + ref[f], product and sum rounded apart; vec as above
int grib_unpack_f32(const int32_t* codes, const float* ref, const float* scale, float* out,
                    int64_t n_fields, int64_t field_size, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    grib_unpack_kernel<true><<<grid_for(n_fields, field_size / 4), kThreads, 0, st>>>(
        codes, ref, scale, out, n_fields, field_size);
  } else {
    grib_unpack_kernel<false><<<grid_for(n_fields, field_size), kThreads, 0, st>>>(
        codes, ref, scale, out, n_fields, field_size);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* grib_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
