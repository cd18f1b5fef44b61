// The Mamba2 mixer's causal depthwise convolution, with its bias and silu, on
// the channel-last layout, for Hopper (sm_90a), with a plain C interface for
// ctypes:
//
//     out[b, t, c] = silu(sum_{k<K} w[k, c] x[b, t - K + 1 + k, c] + bias[c]),
//     x[b, t, c] = 0 for t < 0,
//
// x and out (B, S, C), w (K, C), bias (C,), all contiguous and of one type
// (float32 or bf16), K = 4 (d_conv of every config), C a multiple of 4.
//
// It replaces no TPU kernel: the JAX package convolves with
// jax.lax.conv_general_dilated (src/repro/models/ssm.py, causal_conv1d) and
// leaves the layout to XLA.  It was added because the plain PyTorch version
// (../ref.py, causal_conv1d) was the largest stage of scoring
// mamba2-370m on the card, 30 % of its time at 19x its byte bound: it
// transposes (B, S, C) to (B, C, S), pads it, runs ATen's generic depthwise
// kernel, adds the bias and applies silu in three more passes, and leaves
// its output in the transposed layout, which the SSD scan copies back.
//
// Bound: HBM bytes.  Each element is read once and written once, with 4 K
// multiply-adds and one exponential between, about 2 flop/B, far below the
// card's ridge.  At mamba2-370m's scoring shape (x 256 x 2048 x 2048 and B,
// C 256 x 2048 x 128, bf16) one mixer's three calls move 4.83 GB, 1.44 ms at
// 3.35 TB/s.
//
// Design: move each byte once, in wide accesses, with enough loads in
// flight to cover the memory's latency.  A thread owns kVec = 4 consecutive
// channels (one 8-byte load and store a row in bf16, one 16-byte in float32)
// and walks kTile = 64 rows down the sequence of one batch row; a warp
// covers 256 contiguous bytes of a bf16 row (whole 128-byte lines at every
// C here).  Its K taps x 4 channels of weights and its 4 biases stay in
// registers, and so does the window of the last K rows, a ring indexed at
// compile time, so each row is loaded once and never moved between
// registers; only the K - 1 rows before the tile (zeros before t = 0) are
// read twice, by the tile above, about 5 % of the reads, mostly from L2.
// The rows go K at a time: the next K rows are loaded before the current K
// are computed.  Threads are numbered channel group fastest, then tile, then
// batch row, 128 a block; the three tensors of a mixer (x, B, C) are three
// launches.  No shared memory, no tensor cores.
//
// The exact silu (an expf and an IEEE division with its slow-path check)
// makes the kernel spend about as many instruction slots as bytes allow, so
// registers and instructions decided its shape.  Measured on an H100 80GB
// HBM3 at 700 W, one mixer's three launches at mamba2-370m's scoring
// shape: 8 channels a thread,
// 16-byte rows and a window shifted by register moves 2.76 ms (2.40 with
// row pointers in place of per-row index products); 4 channels 2.09 (2, or
// another unroll, tile, block size or register cap, no better); the ring,
// with bf16 halves unpacked by a shift or a mask, 1.93; prefetching the next
// rows, 128-thread blocks, 1.82-1.91.  A quotient through __fdividef or
// __expf, taken only away from bf16 rounding boundaries so that the result
// stays exact, was slower (2.13-2.17), its branches costing more than the
// instructions it saved.
//
// Rounding is ATen's, so that the kernel equals the plain version bit for
// bit (the plain version's F.conv1d runs ATen's native depthwise kernel,
// conv_depthwise2d_forward, in float32 and bf16): the taps are accumulated
// in float32 from 0, k = 0 first, as fmaf(w_k, x, acc) (a padded position
// adds an exact zero), rounded to the working type; the bias is added in
// float32 and the sum rounded; silu is x / (1 + expf(-x)) in float32, with
// IEEE division and expf (no fast math), rounded once more.
//
// Each entry point launches on the caller's stream and the calling thread's
// current device (the caller makes it the tensors' device), does not
// synchronise, allocates nothing and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 4;     // channels a thread owns
constexpr int kTile = 64;   // rows a thread walks
constexpr int kTaps = 4;    // K, the one instance built

// One thread's kVec = 4 channels of one row, as loaded and stored: one
// 16-byte word in float32, one 8-byte word in bf16
template <typename T>
struct Row;
template <>
struct Row<float> { float4 w; };
template <>
struct Row<__nv_bfloat16> { uint2 w; };
static_assert(kVec == 4, "a Row holds 4 channels");

template <typename T>
__device__ __forceinline__ Row<T> load_row(const T* p) {
  return {__ldg(reinterpret_cast<const decltype(Row<T>::w)*>(p))};
}

template <typename T>
__device__ __forceinline__ Row<T> zero_row() {
  return {};
}

__device__ __forceinline__ void to_float(const Row<float>& r, float (&v)[kVec]) {
  v[0] = r.w.x;
  v[1] = r.w.y;
  v[2] = r.w.z;
  v[3] = r.w.w;
}

// the two bf16 halves of a 32-bit word as floats: the low one shifted up,
// the high one masked (one instruction each)
__device__ __forceinline__ float low_half(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float high_half(unsigned u) { return __uint_as_float(u & 0xFFFF0000u); }

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // rounds each to nearest even
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void to_float(const Row<__nv_bfloat16>& r, float (&v)[kVec]) {
  v[0] = low_half(r.w.x);
  v[1] = high_half(r.w.x);
  v[2] = low_half(r.w.y);
  v[3] = high_half(r.w.y);
}

// each v[c] rounded to T and back: the value a T tensor would hold
__device__ __forceinline__ void round_to(float (&)[kVec], const float*) {}

__device__ __forceinline__ void round_to(float (&v)[kVec], const __nv_bfloat16*) {
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const unsigned u = pack_bf16(v[2 * i], v[2 * i + 1]);
    v[2 * i] = low_half(u);
    v[2 * i + 1] = high_half(u);
  }
}

__device__ __forceinline__ void store_row(float* p, const float (&v)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_row(__nv_bfloat16* p, const float (&v)[kVec]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

// One output row from the window: win[(u + 1 + k) % K] holds the row that
// tap k reads, win[u] the newest; the taps from 0 in float32, rounded, the
// bias, rounded, silu
template <typename T, int K>
__device__ __forceinline__ void conv_row(T* p, const float (&win)[K][kVec], int u,
                                         const float (&wf)[K][kVec], const float (&bf)[kVec]) {
  float y[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) acc = fmaf(wf[k][c], win[(u + 1 + k) % K][c], acc);
    y[c] = acc;
  }
  round_to(y, p);
#pragma unroll
  for (int c = 0; c < kVec; ++c) y[c] += bf[c];
  round_to(y, p);
#pragma unroll
  for (int c = 0; c < kVec; ++c) y[c] = y[c] / (1.0f + expf(-y[c]));
  store_row(p, y);
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
causal_conv1d_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
                     T* __restrict__ out, int64_t batch, int64_t seq, int64_t chans) {
  const int64_t groups = chans / kVec;
  const int64_t tiles = (seq + kTile - 1) / kTile;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= batch * tiles * groups) return;
  const int64_t g = i % groups;
  const int64_t tile = (i / groups) % tiles;
  const int64_t b = i / (groups * tiles);
  const int64_t t_begin = tile * kTile;
  const int rows = static_cast<int>(t_begin + kTile < seq ? kTile : seq - t_begin);
  const int64_t start = (b * seq + t_begin) * chans + g * kVec;  // row t_begin of the tile
  const T* xr = x + start;
  T* outr = out + start;

  float wf[K][kVec], bf[kVec];
#pragma unroll
  for (int k = 0; k < K; ++k) to_float(load_row(w + k * chans + g * kVec), wf[k]);
  to_float(load_row(bias + g * kVec), bf);

  // The window is a ring of K rows: row t_begin + r sits in win[r % K], so
  // the K - 1 rows before the tile sit in win[1..K-1].  K rows are loaded,
  // then computed, a turn; a turn leaves the ring as it found it, so no
  // register moves between turns.
  float win[K][kVec];
#pragma unroll
  for (int j = 1; j < K; ++j) {
    const int back = K - j;  // rows before the tile
    to_float(t_begin >= back ? load_row(xr - back * chans) : zero_row<T>(), win[j]);
  }
  int r0 = 0;
  Row<T> raw[K];
  if (K <= rows) {
#pragma unroll
    for (int u = 0; u < K; ++u) raw[u] = load_row(xr + u * chans);
  }
  for (; r0 + K <= rows; r0 += K) {
    Row<T> next[K];
    if (r0 + 2 * K <= rows) {
#pragma unroll
      for (int u = 0; u < K; ++u) next[u] = load_row(xr + (r0 + K + u) * chans);
    }
#pragma unroll
    for (int u = 0; u < K; ++u) {
      to_float(raw[u], win[u]);
      conv_row(outr + (r0 + u) * chans, win, u, wf, bf);
    }
#pragma unroll
    for (int u = 0; u < K; ++u) raw[u] = next[u];
  }
#pragma unroll
  for (int u = 0; u < K - 1; ++u) {  // the last rows % K rows
    if (r0 + u < rows) {
      to_float(load_row(xr + (r0 + u) * chans), win[u]);
      conv_row(outr + (r0 + u) * chans, win, u, wf, bf);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out,
                   int64_t batch, int64_t seq, int64_t chans, cudaStream_t st) {
  const int64_t threads = batch * ((seq + kTile - 1) / kTile) * (chans / kVec);
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 2147483647) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(out);
  const dim3 grid(static_cast<unsigned>(blocks));
  causal_conv1d_kernel<T, kTaps><<<grid, kThreads, 0, st>>>(xt, wt, bt, ot, batch, seq, chans);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 float32, 1 bf16; taps = K, which must be 4; x, out (batch, seq,
// chans), w (taps, chans), bias (chans,), contiguous and 16-byte aligned,
// chans % 4 == 0
int causal_conv1d_launch(int dtype, int taps, const void* x, const void* w, const void* bias,
                         void* out, int64_t batch, int64_t seq, int64_t chans, void* stream) {
  if (batch < 1 || seq < 1 || chans < kVec || chans % kVec || taps != kTaps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(x, w, bias, out, batch, seq, chans, st));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(x, w, bias, out, batch, seq, chans, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* causal_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
