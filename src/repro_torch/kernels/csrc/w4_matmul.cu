// K2: y = [qdq_act(x)] @ dequant(packed W4), f32 accumulation.
//
// Replaces the TPU kernels src/repro/kernels/w4_matmul.py:w4_matmul_2d and
// :w4a4_matmul_2d (_w4_call / _kernel / _decode_block / _snap_tile,
// pallas_call at :182). Covers the TPU kernel's format space: signed and
// unsigned ExMy weights, scalar or per-channel scale/zp, and the fused
// signed or unsigned act snap (act_enabled = 0 is w4_matmul_2d). An
// unsigned weight's zero-point enters as the TPU kernel adds it, as the
// rank-1 term zp_n * rowsum(x_q) after the product.
// See w4_gemm.cuh for the tiling and what bounds it.
#include <cuda_runtime.h>

#include "w4_gemm.cuh"

namespace {

template <typename T>
struct DenseA {
  const T* x;
  int K;
  const float* maxval;
  const float* zp;
  int exp_bits, man_bits, is_signed, enabled;
  msfp::ActQ q;

  __device__ __forceinline__ void init() {
    if (enabled) q.load(maxval, zp, exp_bits, man_bits, is_signed);
  }
  __device__ __forceinline__ float operator()(int m, int k) const {
    const float v = msfp::to_f<T>(x[(size_t)m * K + k]);
    return enabled ? msfp::round_to<T>(q(v)) : v;
  }
};

template <typename T>
int run(const void* x, const msfp::WQ& wq, int M, int N, int K,
        const void* a_maxval, const void* a_zp, int a_exp, int a_man,
        int a_signed, int act_enabled, void* out, cudaStream_t s) {
  DenseA<T> a{(const T*)x, K, (const float*)a_maxval, (const float*)a_zp,
              a_exp, a_man, a_signed, act_enabled, {}};
  return w4gemm::launch<T>(a, wq, M, N, K, (T*)out, s);
}

}  // namespace

extern "C" int w4_matmul_launch(const void* x, const void* packed,
                                const void* scale, const void* zp,
                                int scale_stride, int M, int N, int K,
                                int w_exp, int w_man, int w_signed,
                                const void* a_maxval, const void* a_zp,
                                int a_exp, int a_man, int a_signed,
                                int act_enabled, int dtype, void* out,
                                void* stream) {
  msfp::WQ wq{(const uint8_t*)packed, (const float*)scale, (const float*)zp,
              scale_stride, w_exp, w_man, w_signed};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return run<float>(x, wq, M, N, K, a_maxval, a_zp, a_exp, a_man, a_signed,
                      act_enabled, out, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, wq, M, N, K, a_maxval, a_zp, a_exp, a_man,
                              a_signed, act_enabled, out, s);
  return (int)cudaErrorInvalidValue;
}
