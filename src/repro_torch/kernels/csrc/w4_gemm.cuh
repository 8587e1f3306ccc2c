// The tiled f32 GEMM body shared by K2 (w4_matmul.cu) and K3 (conv.cu):
//
//   out[m, n] = sum_k A(m, k) * decode(packed)[k, n]      (f32 accumulate)
//             [+ zp[n] * sum_k A(m, k)           unsigned weight formats]
//
// A is an operand functor: K2 reads a row-major (M, K) activation, K3
// gathers the taps of an NHWC image (implicit GEMM); both apply the fused
// MSFP act snap as they load. Each 256-thread block owns a 64x64 output
// tile and walks K in steps of 16: it snaps its A tile and decodes its W
// tile (packed nibbles -> f32, scale applied) into shared memory,
// then every thread accumulates a 4x4 micro-tile in registers. An unsigned
// weight's zero-point is not decoded into the tile: as in the TPU kernel
// (w4_matmul.py:126-129, conv.py:217-220), the block also sums its
// A rows and adds the rank-1 term zp[n] * rowsum[m] at the end. Out-of-range
// rows, columns and k read exact zero after the snap, which is the
// quantize-then-pad order of the reference and re-zeroes the K tail for
// unsigned act grids. There is no counterpart to the TPU kernel's
// snap-once scratch (w4_matmul.py:102-113): it relies on the TPU's
// sequential grid, which CUDA blocks do not have, so each block snaps the
// act tiles it loads.
//
// Speed: this simple SIMT kernel runs on the f32 FMA units. chip_smoke.py
// reports it beside a bound taken at the bf16 tensor-core rate, which the
// FP4 operands allow; reaching it (wgmma, TMA) is later work.
#pragma once

#include <cuda_runtime.h>

#include "msfp.cuh"

namespace w4gemm {

constexpr int BM = 64, BN = 64, BK = 16, NT = 256;

template <typename T, typename ALoad, bool ZP>
__global__ void __launch_bounds__(NT)
w4_gemm_kernel(ALoad aload, msfp::WQ wq, int M, int N, int K,
               T* __restrict__ out) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  ALoad a = aload;
  a.init();

  // W tile: a thread always loads column tid % BN (rows tid / BN + 4r).
  const int bc = tid % BN, bn = n0 + bc, br0 = tid / BN;
  const bool bn_ok = bn < N;
  msfp::WCol col{0, 0, 0.f};
  if (bn_ok) col = msfp::wcol(wq, bn, N);
  const int half = N / 2;
  // A tile: a thread always loads k column tid % BK (rows tid / BK + 16r).
  const int ac = tid % BK, ar0 = tid / BK;
  const int tx = tid % 16, ty = tid / 16;

  float acc[4][4], rsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int ka = k0 + ac;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ar0 + 16 * r, m = m0 + row;
      As[ac][row] = (m < M && ka < K) ? a(m, ka) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kk = br0 + 4 * r, k = k0 + kk;
      float w = 0.f;
      if (bn_ok && k < K) {
        const int code = (wq.packed[(size_t)k * half + col.j] >> col.shift) & 0xF;
        w = msfp::decode(code, wq, col);
      }
      Bs[kk][bc] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (ZP) rsum[i] = __fadd_rn(rsum[i], ar[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], bw[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float v = acc[i][j];
      if (ZP) v = __fadd_rn(v, __fmul_rn(rsum[i], wq.zp[n * wq.scale_stride]));
      out[(size_t)m * N + n] = msfp::from_f<T>(v);
    }
  }
}

template <typename T, typename ALoad>
int launch(const ALoad& a, const msfp::WQ& wq, int M, int N, int K, T* out,
           cudaStream_t s) {
  if (M <= 0 || N <= 0) return 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  if (wq.is_signed)
    w4_gemm_kernel<T, ALoad, false><<<grid, NT, 0, s>>>(a, wq, M, N, K, out);
  else
    w4_gemm_kernel<T, ALoad, true><<<grid, NT, 0, s>>>(a, wq, M, N, K, out);
  return (int)cudaGetLastError();
}

}  // namespace w4gemm
