// K3: NHWC conv as an implicit GEMM on a packed HWIO W4 weight.
//
// Replaces the TPU kernel src/repro/kernels/conv.py:w4a4_conv2d_implicit
// (_implicit_kernel, pallas_call at :292). GEMM rows are output pixels
// (b, oh, ow), columns output channels, and k = (ki * kw + kj) * cin + c
// walks the pack's (kh*kw*cin, cout/2) rows, the same flattening the TPU
// kernel views as (kh*kw, cin, cout/2). The TPU kernel hands each program
// one whole padded spatial slab (2 MB at 32x32x512 f32, far over the
// 227 KB a block may use); here each block owns a 64-pixel x 64-channel
// output tile and gathers its taps from the NHWC input with bounds checks:
// a tap outside the image reads exact zero after the (signed or unsigned)
// act snap, which is the quantize-then-pad order (conv.py:23-33,
// ref.py:44-45). Padding is explicit (lo, hi) per axis, so SAME's
// asymmetric (0, 1) for a 3x3 stride-2 conv is honoured. See w4_gemm.cuh
// for the tiling and what bounds it.
#include <cuda_runtime.h>

#include "w4_gemm.cuh"

namespace {

template <typename T>
struct ConvA {
  const T* x;
  int H, W, C, OH, OW, KW, SH, SW, PH0, PW0;
  const float* maxval;
  const float* zp;
  int exp_bits, man_bits, is_signed, enabled;
  msfp::ActQ q;

  __device__ __forceinline__ void init() {
    if (enabled) q.load(maxval, zp, exp_bits, man_bits, is_signed);
  }
  __device__ __forceinline__ float operator()(int m, int k) const {
    const int ow = m % OW, t = m / OW;
    const int oh = t % OH, b = t / OH;
    const int c = k % C, tap = k / C;
    const int kj = tap % KW, ki = tap / KW;
    const int ih = oh * SH - PH0 + ki, iw = ow * SW - PW0 + kj;
    if (ih < 0 || ih >= H || iw < 0 || iw >= W) return 0.f;
    const float v = msfp::to_f<T>(x[(((size_t)b * H + ih) * W + iw) * C + c]);
    return enabled ? msfp::round_to<T>(q(v)) : v;
  }
};

template <typename T>
int run(const void* x, const msfp::WQ& wq, int B, int H, int W, int C,
        int OH, int OW, int KH, int KW, int SH, int SW, int PH0, int PW0,
        int N, const void* a_maxval, const void* a_zp, int a_exp, int a_man,
        int a_signed, int act_enabled, void* out, cudaStream_t s) {
  ConvA<T> a{(const T*)x, H, W, C, OH, OW, KW, SH, SW, PH0, PW0,
             (const float*)a_maxval, (const float*)a_zp, a_exp, a_man,
             a_signed, act_enabled, {}};
  return w4gemm::launch<T>(a, wq, B * OH * OW, N, KH * KW * C, (T*)out, s);
}

}  // namespace

extern "C" int w4_conv2d_launch(const void* x, const void* packed,
                                const void* scale, const void* zp,
                                int scale_stride, int B, int H, int W, int C,
                                int OH, int OW, int KH, int KW, int SH, int SW,
                                int PH0, int PW0, int N, int w_exp, int w_man,
                                int w_signed, const void* a_maxval,
                                const void* a_zp, int a_exp, int a_man,
                                int a_signed, int act_enabled, int dtype,
                                void* out, void* stream) {
  msfp::WQ wq{(const uint8_t*)packed, (const float*)scale, (const float*)zp,
              scale_stride, w_exp, w_man, w_signed};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return run<float>(x, wq, B, H, W, C, OH, OW, KH, KW, SH, SW, PH0, PW0, N,
                      a_maxval, a_zp, a_exp, a_man, a_signed, act_enabled,
                      out, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, wq, B, H, W, C, OH, OW, KH, KW, SH, SW, PH0,
                              PW0, N, a_maxval, a_zp, a_exp, a_man, a_signed,
                              act_enabled, out, s);
  return (int)cudaErrorInvalidValue;
}
