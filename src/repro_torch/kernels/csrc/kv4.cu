// K4/K5: the FP4 (signed E2M1) KV-cache codec.
//
// K4 kv4_encode replaces the TPU kernel src/repro/kernels/kv4.py:kv4_encode_2d
// (_enc_kernel / _encode_block, pallas_call at :72); K5 kv4_decode replaces
// :kv4_decode_2d (_dec_kernel, pallas_call at :96). One row is one (token,
// kv-head) vector of hd values: an f16 absmax scale and hd/2 bytes of
// split-half nibbles (low nibble column j, high nibble column j + hd/2), the
// sign in bit 3 of each code.
//
// Both are bound by bytes on this card: a few dozen ALU operations per
// element against 2-4 bytes read or written. The TPU version tiles 256 rows
// a grid step; here
//   * K4 gives each row one warp: the lanes stride over the hd/2 column
//     pairs, the absmax is a warp-shuffle max, and each lane writes the
//     bytes of its pairs (no shared memory, no block-level sync);
//   * K5 is a grid-stride loop over the packed bytes: each thread decodes
//     one byte into its two columns.
// The arithmetic follows the compiled Pallas kernels bit for bit:
//   encode  scale = max(absmax, 1e-6) (f32), inv = a true 1/scale,
//           y = (|t| * inv) * 6, snapped with rintf at the exponent-bit
//           octave in [0, 2], clamped to 6; sign from t < 0 (so -0.0 is
//           positive); the scale is stored as f16 (RNE), the codes use the
//           f32 scale;
//   decode  val * (f32(scale) * rcp(6)): under jit XLA turns the division
//           by the constant 6 into a multiply by its f32 reciprocal.
// Every rounding is spelled out (__fmul_rn, __frcp_rn); build without
// --use_fast_math.
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "msfp.cuh"

namespace {

constexpr int E = 2, M = 1;        // signed E2M1
constexpr float BASE_MAX = 6.f;
constexpr int THREADS = 256;       // 8 warps: 8 rows per block in K4

__device__ __forceinline__ int encode_one(float t, float inv) {
  const float y = __fmul_rn(__fmul_rn(fabsf(t), inv), BASE_MAX);
  const int c = msfp::encode_mag(msfp::snap_base(y, E, M, BASE_MAX), E, M);
  return t < 0.f ? (c | 8) : c;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
kv4_encode_kernel(const T* __restrict__ t, uint8_t* __restrict__ packed,
                  __half* __restrict__ scale, int rows, int hd) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;           // a whole warp leaves together
  const int half = hd / 2;
  const T* x = t + (size_t)row * hd;
  float amax = 0.f;
  for (int j = lane; j < hd; j += 32) amax = fmaxf(amax, fabsf(msfp::to_f<T>(x[j])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = fmaxf(amax, 1e-6f);
  const float inv = __frcp_rn(s);
  uint8_t* out = packed + (size_t)row * half;
  for (int j = lane; j < half; j += 32) {
    const int lo = encode_one(msfp::to_f<T>(x[j]), inv);
    const int hi = encode_one(msfp::to_f<T>(x[j + half]), inv);
    out[j] = (uint8_t)(lo | (hi << 4));
  }
  if (lane == 0) scale[row] = __float2half_rn(s);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
kv4_decode_kernel(const uint8_t* __restrict__ packed,
                  const __half* __restrict__ scale, T* __restrict__ out,
                  long long n_bytes, int half) {
  const float rcp = __frcp_rn(BASE_MAX);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_bytes; i += stride) {
    const long long row = i / half;
    const int j = (int)(i - row * half);
    const float sc = __fmul_rn(__half2float(scale[row]), rcp);
    const int b = packed[i];
    T* o = out + row * 2 * half;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int code = (b >> (4 * h)) & 0xF;
      const float v = __fmul_rn(msfp::decode_mag(code & 7, E, M), sc);
      o[j + h * half] = msfp::from_f<T>((code & 8) ? -v : v);
    }
  }
}

long long grid_for(long long work) {
  long long blocks = (work + THREADS - 1) / THREADS;
  return blocks > 132 * 16 ? 132 * 16 : (blocks < 1 ? 1 : blocks);
}

}  // namespace

extern "C" int kv4_encode_launch(const void* t, void* packed, void* scale,
                                 int rows, int hd, int dtype, void* stream) {
  if (rows <= 0) return 0;
  if (hd <= 0 || hd % 2) return (int)cudaErrorInvalidValue;
  const int per_block = THREADS / 32;
  const int blocks = (rows + per_block - 1) / per_block;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    kv4_encode_kernel<float><<<blocks, THREADS, 0, s>>>(
        (const float*)t, (uint8_t*)packed, (__half*)scale, rows, hd);
  } else if (dtype == 1) {
    kv4_encode_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        (const __nv_bfloat16*)t, (uint8_t*)packed, (__half*)scale, rows, hd);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int kv4_decode_launch(const void* packed, const void* scale,
                                 void* out, long long rows, int half,
                                 int dtype, void* stream) {
  const long long n = rows * half;
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (int)grid_for(n);
  if (dtype == 0) {
    kv4_decode_kernel<float><<<blocks, THREADS, 0, s>>>(
        (const uint8_t*)packed, (const __half*)scale, (float*)out, n, half);
  } else if (dtype == 1) {
    kv4_decode_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        (const uint8_t*)packed, (const __half*)scale, (__nv_bfloat16*)out, n,
        half);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
