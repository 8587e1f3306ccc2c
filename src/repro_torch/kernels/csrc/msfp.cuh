// MSFP arithmetic shared by the kernels: the act snap (port of
// src/repro/kernels/msfp_quant.py:_qdq_block), the nibble decode (port of
// src/repro/kernels/w4_matmul.py:_decode_block) and the E2M1 code <->
// magnitude maps that the KV-cache codec (kv4.cu) also uses.
//
// Bit-exactness with the plain PyTorch versions (quant/fakequant.py:fp_qdq,
// core/qmodule.py:decode_codes) rests on these rules:
//   * the octave comes from the exponent bits and the step is built from
//     bits (no log2f/exp2f), as quant/formats.py does;
//   * rounding is rintf (half to even), never roundf;
//   * every product/sum that the reference rounds separately is an
//     explicit __fmul_rn/__fadd_rn, so nvcc cannot contract it into an FMA;
//   * a division by a power of two is a multiply by its exact reciprocal
//     (the snap's y / step is y * 2^-e): same real result, same rounding;
//   * maxval / base_max is maxval * rcp(base_max), and the unsigned
//     q * scale + zp is one __fmaf_rn, as compiled XLA (and the Pallas
//     kernels) compute them (fakequant.py:grid_scale, fakequant.py:fma).
// Build without --use_fast_math: it would make the divisions approximate.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace msfp {

// Grid maximum of an ExMy base grid (formats.py:FPFormat.base_max).
__host__ __device__ inline float base_max(int exp_bits, int man_bits) {
  if (exp_bits == 0) {
    return (float)((1 << man_bits) - 1) / (float)(1 << man_bits);
  }
  float top = (float)(1ll << ((1 << exp_bits) - 2));
  return top * (2.0f - 1.0f / (float)(1 << man_bits));
}

__device__ __forceinline__ float pow2i(int e) {  // exact 2^e, e in [-126, 127]
  return __int_as_float((e + 127) << 23);
}

// Snap y >= 0 to the base grid, clamp to base_max (NaN passes through).
__device__ __forceinline__ float snap_base(float y, int exp_bits, int man_bits,
                                          float bmax) {
  int e = -man_bits;
  if (exp_bits != 0) {
    int ex = (int)((__float_as_uint(y) >> 23) & 0xFFu) - 127;
    const int max_oct = (1 << exp_bits) - 2;
    ex = ex < 0 ? 0 : (ex > max_oct ? max_oct : ex);
    e = ex - man_bits;
  }
  // y / step as y * 2^-e: step is an exact power of two, so the product
  // and the quotient are the same real number and round to the same bits
  const float q = __fmul_rn(rintf(__fmul_rn(y, pow2i(-e))), pow2i(e));
  return q > bmax ? bmax : q;
}

// Per-tensor act quantizer, resolved once per thread from device memory.
struct ActQ {
  float scale, inv, zp, bmax;
  int exp_bits, man_bits, is_signed;

  __device__ __forceinline__ void load(const float* maxval_p, const float* zp_p,
                                       int e, int m, int sgn) {
    exp_bits = e;
    man_bits = m;
    is_signed = sgn;
    bmax = base_max(e, m);
    scale = __fmul_rn(*maxval_p, __frcp_rn(bmax));
    inv = scale > 0.f ? __fdiv_rn(1.f, fmaxf(scale, 1e-30f)) : 0.f;
    zp = *zp_p;
  }

  // maxval / base_max as a true division in place of the reciprocal
  // multiply: the fine-tune's act STE, whose plan parameters compiled XLA
  // folds as constants (quant/fakequant.py, form "folded")
  __device__ __forceinline__ void fold_scale(const float* maxval_p) {
    scale = __fdiv_rn(*maxval_p, bmax);
    inv = scale > 0.f ? __fdiv_rn(1.f, fmaxf(scale, 1e-30f)) : 0.f;
  }

  // signed: sign(x) * (snap(|x| * inv) * scale)
  // unsigned: fma(snap(max((x - zp) * inv, 0)), scale, zp)
  __device__ __forceinline__ float operator()(float x) const {
    if (is_signed) {
      const float q = __fmul_rn(
          snap_base(__fmul_rn(fabsf(x), inv), exp_bits, man_bits, bmax), scale);
      const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);  // torch.sign
      return __fmul_rn(s, q);
    }
    float y = __fmul_rn(__fsub_rn(x, zp), inv);
    y = y < 0.f ? 0.f : y;
    return __fmaf_rn(snap_base(y, exp_bits, man_bits, bmax), scale, zp);
  }
};

// Packed-W4 weight: split-half nibbles (K, N/2), scale/zp scalar
// (stride 0) or per output channel (stride 1).
struct WQ {
  const uint8_t* packed;
  const float* scale;
  const float* zp;
  int scale_stride, exp_bits, man_bits, is_signed;
};

// One column's decode constants: where its nibble lives and its scale.
struct WCol {
  int j, shift;
  float sc;
};

__device__ __forceinline__ WCol wcol(const WQ& w, int n, int N) {
  const int half = N / 2;
  WCol c;
  c.j = n < half ? n : n - half;
  c.shift = n < half ? 0 : 4;
  c.sc = __fmul_rn(w.scale[n * w.scale_stride],
                   __frcp_rn(base_max(w.exp_bits, w.man_bits)));
  return c;
}

// Unsigned code [p | m] -> base-grid magnitude: p = 0 is subnormal m/2^M,
// p >= 1 is 2^(p-1) * (1 + m/2^M) (formats.py:quant_codes). Exact.
__device__ __forceinline__ float decode_mag(int code, int exp_bits,
                                            int man_bits) {
  const int p = code >> man_bits;
  const float m = (float)(code & ((1 << man_bits) - 1));
  const float frac = __fmul_rn(m, pow2i(-man_bits));
  return (exp_bits == 0 || p == 0)
             ? frac : __fmul_rn(pow2i(p - 1), __fadd_rn(1.f, frac));
}

// A base-grid point v >= 0 -> its unsigned code, the inverse of decode_mag
// (qmodule.py:grid_codes): v lies on the grid, so (p, m) come back exactly.
__device__ __forceinline__ int encode_mag(float v, int exp_bits,
                                          int man_bits) {
  const float two_m = pow2i(man_bits);
  if (exp_bits == 0) return (int)rintf(__fmul_rn(v, two_m));
  if (v < 1.f) return (int)rintf(__fmul_rn(v, two_m));
  int oct = (int)((__float_as_uint(v) >> 23) & 0xFFu) - 127;
  const int max_oct = (1 << exp_bits) - 2;
  oct = oct < 0 ? 0 : (oct > max_oct ? max_oct : oct);
  const float frac = __fsub_rn(__fmul_rn(v, pow2i(-oct)), 1.f);
  return ((oct + 1) << man_bits) | (int)rintf(__fmul_rn(frac, two_m));
}

// code -> mag * (scale * rcp(base_max)), negated by the sign bit for signed
// formats (w4_matmul.py:_decode_block). An unsigned format's zero-point is
// not decoded here: the GEMM adds it as the rank-1 term zp_n * rowsum(A).
__device__ __forceinline__ float decode(int code, const WQ& w, const WCol& c) {
  const int nbits = w.exp_bits + w.man_bits;
  int sign = 0;
  if (w.is_signed) {
    sign = (code >> nbits) & 1;
    code &= (1 << nbits) - 1;
  }
  const float v = __fmul_rn(decode_mag(code, w.exp_bits, w.man_bits), c.sc);
  return sign ? -v : v;
}

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The working type's rounding of a snapped act (the reference's qdq
// returns x.dtype): identity for f32, RNE to bf16 for bf16.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

}  // namespace msfp
