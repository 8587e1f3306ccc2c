// K3: NHWC conv as an implicit GEMM on a packed HWIO W4 weight.
//
// Replaces the TPU kernel src/repro/kernels/conv.py:w4a4_conv2d_implicit
// (_implicit_kernel, pallas_call at :292). GEMM rows are output pixels
// (b, oh, ow), columns output channels, and k = (ki * kw + kj) * cin + c
// walks the pack's (kh*kw*cin, cout/2) rows, the same flattening the TPU
// kernel views as (kh*kw, cin, cout/2). The TPU kernel hands each program
// one whole padded spatial slab (2 MB at 32x32x512 f32, far over the
// 227 KB a block may use); here each block owns a tile of output pixels
// and gathers their taps from the NHWC input: a tap outside the image
// reads exact zero after the (signed or unsigned) act snap, which is the
// quantize-then-pad order (conv.py:23-33, ref.py:44-45). Padding is
// explicit (lo, hi) per axis, so SAME's asymmetric (0, 1) for a 3x3
// stride-2 conv is honoured.
//
// Bound on an H100: bytes at 32x32 and 16x16, operations at the 8x8 and
// 4x4 levels (K up to 9 * 512 = 4608 at M = 512 or 128); far below both,
// occupancy and latency decide. The design (w4_gemm.cuh): bf16 tensor-core
// MMAs on the snapped grid operand, a cp.async ring, split-K at small M.
// The gather: each row's (b, oh, ow) is resolved once per block into
// shared memory, and when cin is a multiple of the k-step (every conv of
// ddim-cifar10: cin in {128, 256, 384, 512}) a k-step is one tap and a
// channel chunk, so a row's chunk is one 16-byte-aligned run of the NHWC
// input (zero-filled outside the image) and needs one division a step.
// Any other cin takes an element-wise gather with the same semantics.
#include <cuda_runtime.h>

#include "w4_gemm.cuh"

namespace {

template <typename T>
struct ConvA {
  const T* x;
  int M, K, H, W, C, OH, OW, KW, SH, SW, PH0, PW0;
  const float* maxval;
  const float* zp;
  int exp_bits, man_bits, is_signed, enabled;
  int vec;   // chunked: C % BK == 0, C * sizeof(T) % 16 == 0, x aligned

  // rowinfo[3r .. 3r+2] = (b*H*W, oh*SH - PH0, ow*SW - PW0); a row past M
  // gets an ih that no tap brings into the image
  __device__ __forceinline__ void prep(int* ri, int m0, int rows, int tid,
                                       int nt) const {
    for (int r = tid; r < rows; r += nt) {
      const int m = m0 + r;
      if (m < M) {
        const int ow = m % OW, t = m / OW, oh = t % OH, b = t / OH;
        ri[3 * r] = b * H * W;
        ri[3 * r + 1] = oh * SH - PH0;
        ri[3 * r + 2] = ow * SW - PW0;
      } else {
        ri[3 * r] = 0;
        ri[3 * r + 1] = -(1 << 29);
        ri[3 * r + 2] = 0;
      }
    }
  }
  __device__ __forceinline__ void load_q(msfp::ActQ& q) const {
    if (enabled) q.load(maxval, zp, exp_bits, man_bits, is_signed);
  }
  // is tap `tap` of row r inside the image; its pixel index if so
  __device__ __forceinline__ bool inside(const int* ri, int r, int tap,
                                         int& pix) const {
    const int ki = tap / KW, kj = tap - ki * KW;
    const int ih = ri[3 * r + 1] + ki, iw = ri[3 * r + 2] + kj;
    pix = ri[3 * r] + ih * W + iw;
    return ih >= 0 && ih < H && iw >= 0 && iw < W;
  }
  template <int ROWS, int BK, int RXS, int NT>
  __device__ __forceinline__ void load(unsigned char* raw, const int* ri,
                                       int m0, int k0, int tid) const {
    if (vec) {   // one tap, channels c0 .. c0 + BK
      constexpr int EPC = 16 / (int)sizeof(T), CPR = BK / EPC;
      const int tap = k0 / C, c0 = k0 - tap * C;
      for (int c = tid; c < ROWS * CPR; c += NT) {
        const int r = c / CPR, q = c % CPR;
        int pix;
        const bool ok = inside(ri, r, tap, pix);
        w4gemm::cp_async16(raw + r * RXS + q * 16,
                           ok ? x + (size_t)pix * C + c0 + q * EPC : x, ok);
      }
    } else {
      for (int e = tid; e < ROWS * BK; e += NT) {
        const int r = e / BK, kk = e % BK, k = k0 + kk;
        T v = msfp::from_f<T>(0.f);
        if (k < K) {
          const int tap = k / C;
          int pix;
          if (inside(ri, r, tap, pix)) v = x[(size_t)pix * C + (k - tap * C)];
        }
        reinterpret_cast<T*>(raw + r * RXS)[kk] = v;
      }
    }
  }
  // bit i: element (row r, k + i) is a tap inside the image (n <= 16)
  __device__ __forceinline__ unsigned valid_mask(const int* ri, int r, int,
                                                 int k, int n) const {
    int pix;
    if (vec) return inside(ri, r, k / C, pix) ? (1u << n) - 1u : 0u;
    unsigned mask = 0u;
    for (int i = 0; i < n; ++i)
      if (k + i < K && inside(ri, r, (k + i) / C, pix)) mask |= 1u << i;
    return mask;
  }
};

template <typename T>
int run(const void* x, const msfp::WQ& wq, int B, int H, int W, int C,
        int OH, int OW, int KH, int KW, int SH, int SW, int PH0, int PW0,
        int N, const void* a_maxval, const void* a_zp, int a_exp, int a_man,
        int a_signed, int act_enabled, int cfg, int splits, void* ws,
        void* out, cudaStream_t s) {
  const int bk = w4gemm::Large::BK;   // every tile's k step
  const int vec = ((reinterpret_cast<uintptr_t>(x) & 15) == 0) &&
                  C % bk == 0 && ((size_t)C * sizeof(T)) % 16 == 0;
  const int M = B * OH * OW, K = KH * KW * C;
  ConvA<T> a{(const T*)x, M, K, H, W, C, OH, OW, KW, SH, SW, PH0, PW0,
             (const float*)a_maxval, (const float*)a_zp, a_exp, a_man,
             a_signed, act_enabled, vec};
  return w4gemm::launch<T>(a, wq, M, N, K, cfg, splits, ws, (T*)out, s);
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
                                int cfg, int splits, void* ws, void* out,
                                void* stream) {
  msfp::WQ wq{(const uint8_t*)packed, (const float*)scale, (const float*)zp,
              scale_stride, w_exp, w_man, w_signed};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return run<float>(x, wq, B, H, W, C, OH, OW, KH, KW, SH, SW, PH0, PW0, N,
                      a_maxval, a_zp, a_exp, a_man, a_signed, act_enabled,
                      cfg, splits, ws, out, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, wq, B, H, W, C, OH, OW, KH, KW, SH, SW, PH0,
                              PW0, N, a_maxval, a_zp, a_exp, a_man, a_signed,
                              act_enabled, cfg, splits, ws, out, s);
  return (int)cudaErrorInvalidValue;
}
