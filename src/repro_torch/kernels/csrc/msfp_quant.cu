// K1: elementwise MSFP quantize-dequantize with a per-tensor (maxval, zp).
//
// Replaces the TPU kernel src/repro/kernels/msfp_quant.py:msfp_qdq_2d
// (_kernel / _qdq_block, pallas_call at :69). Bound by bytes on this card:
// one read and one write per element, a few dozen ALU operations. The TPU
// version tiles (block_rows, block_cols) to the 128-lane layout; here a
// grid-stride loop over numel does the same job for any shape, including
// the io site's (M, 3) act where N is odd and tiny. maxval/zp are read from
// device pointers, so a launch never syncs with the host.
#include <cuda_runtime.h>

#include "msfp.cuh"

namespace {

template <typename T>
__global__ void msfp_qdq_kernel(const T* __restrict__ x, T* __restrict__ out,
                                long long n, const float* maxval,
                                const float* zp, int exp_bits, int man_bits,
                                int is_signed) {
  msfp::ActQ q;
  q.load(maxval, zp, exp_bits, man_bits, is_signed);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = msfp::from_f<T>(q(msfp::to_f<T>(x[i])));
  }
}

}  // namespace

extern "C" int msfp_qdq_launch(const void* x, void* out, long long n,
                               const void* maxval, const void* zp,
                               int exp_bits, int man_bits, int is_signed,
                               int dtype, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    msfp_qdq_kernel<float><<<(int)blocks, threads, 0, s>>>(
        (const float*)x, (float*)out, n, (const float*)maxval,
        (const float*)zp, exp_bits, man_bits, is_signed);
  } else if (dtype == 1) {
    msfp_qdq_kernel<__nv_bfloat16><<<(int)blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)out, n, (const float*)maxval,
        (const float*)zp, exp_bits, man_bits, is_signed);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
