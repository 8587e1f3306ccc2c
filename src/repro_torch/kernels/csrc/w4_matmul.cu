// K2: y = [qdq_act(x)] @ dequant(packed W4), f32 accumulation.
//
// Replaces the TPU kernels src/repro/kernels/w4_matmul.py:w4_matmul_2d and
// :w4a4_matmul_2d (_w4_call / _kernel / _decode_block / _snap_tile,
// pallas_call at :182). Covers the TPU kernel's format space: signed and
// unsigned ExMy weights, scalar or per-channel scale/zp, and the fused
// signed or unsigned act snap (act_enabled = 0 is w4_matmul_2d). An
// unsigned weight's zero-point enters as the TPU kernel adds it, as the
// rank-1 term zp_n * rowsum(x_q) after the product.
//
// Bound on an H100: bytes at every main-path shape (M = 8 at the LM's 210
// dense sites a step and at the diffusion temb sites, M = 2048/128 at the
// attention projections); the launch is latency-bound well above that.
// The design (w4_gemm.cuh): bf16 tensor-core MMAs on exact grid operands,
// y^T = W^T x^T at M <= 8 so 8 tokens fill the MMA's n = 8 side, a
// cp.async ring, and a deterministic split-K that spreads the weight's
// bytes over the SMs. Rows whose bytes are a multiple of 16 load as
// 16-byte copies; any other K loads element by element.
#include <cuda_runtime.h>

#include "w4_gemm.cuh"

namespace {

template <typename T>
struct DenseA {
  const T* x;
  int M, K;
  const float* maxval;
  const float* zp;
  int exp_bits, man_bits, is_signed, enabled;
  int vec;   // 16-byte row chunks: K * sizeof(T) % 16 == 0, x aligned

  __device__ __forceinline__ void prep(int*, int, int, int, int) const {}
  __device__ __forceinline__ void load_q(msfp::ActQ& q) const {
    if (enabled) q.load(maxval, zp, exp_bits, man_bits, is_signed);
  }
  // one raw stage: ROWS x BK elements of x from (m0, k0), zero outside
  template <int ROWS, int BK, int RXS, int NT>
  __device__ __forceinline__ void load(unsigned char* raw, const int*, int m0,
                                       int k0, int tid) const {
    if (vec) {
      constexpr int EPC = 16 / (int)sizeof(T), CPR = BK / EPC;
      for (int c = tid; c < ROWS * CPR; c += NT) {
        const int r = c / CPR, q = c % CPR, m = m0 + r, k = k0 + q * EPC;
        const bool ok = m < M && k < K;
        w4gemm::cp_async16(raw + r * RXS + q * 16,
                           ok ? x + (size_t)m * K + k : x, ok);
      }
    } else {
      for (int e = tid; e < ROWS * BK; e += NT) {
        const int r = e / BK, kk = e % BK, m = m0 + r, k = k0 + kk;
        reinterpret_cast<T*>(raw + r * RXS)[kk] =
            (m < M && k < K) ? x[(size_t)m * K + k] : msfp::from_f<T>(0.f);
      }
    }
  }
  // bit i: element (m, k + i) lies inside x (n <= 16)
  __device__ __forceinline__ unsigned valid_mask(const int*, int, int m, int k,
                                                 int n) const {
    if (m >= M || k >= K) return 0u;
    const int left = K - k < n ? K - k : n;
    return (1u << left) - 1u;
  }
};

template <typename T>
int run(const void* x, const msfp::WQ& wq, int M, int N, int K,
        const void* a_maxval, const void* a_zp, int a_exp, int a_man,
        int a_signed, int act_enabled, int cfg, int splits, void* ws,
        void* out, cudaStream_t s) {
  const int vec = ((reinterpret_cast<uintptr_t>(x) & 15) == 0) &&
                  ((size_t)K * sizeof(T)) % 16 == 0;
  DenseA<T> a{(const T*)x, M, K, (const float*)a_maxval, (const float*)a_zp,
              a_exp, a_man, a_signed, act_enabled, vec};
  return w4gemm::launch<T>(a, wq, M, N, K, cfg, splits, ws, (T*)out, s);
}

}  // namespace

extern "C" int w4_matmul_launch(const void* x, const void* packed,
                                const void* scale, const void* zp,
                                int scale_stride, int M, int N, int K,
                                int w_exp, int w_man, int w_signed,
                                const void* a_maxval, const void* a_zp,
                                int a_exp, int a_man, int a_signed,
                                int act_enabled, int dtype, int cfg,
                                int splits, void* ws, void* out,
                                void* stream) {
  msfp::WQ wq{(const uint8_t*)packed, (const float*)scale, (const float*)zp,
              scale_stride, w_exp, w_man, w_signed};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return run<float>(x, wq, M, N, K, a_maxval, a_zp, a_exp, a_man, a_signed,
                      act_enabled, cfg, splits, ws, out, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, wq, M, N, K, a_maxval, a_zp, a_exp, a_man,
                              a_signed, act_enabled, cfg, splits, ws, out, s);
  return (int)cudaErrorInvalidValue;
}
