// The tensor-core W4 GEMM body shared by K2 (w4_matmul.cu) and K3 (conv.cu):
//
//   out[m, n] = sum_k A(m, k) * decode(packed)[k, n]      (f32 accumulate)
//             [+ zp[n] * sum_k A(m, k)           unsigned weight formats]
//
// A is an operand loader: K2 reads a row-major (M, K) activation, K3
// gathers the taps of an NHWC image (implicit GEMM); the fused MSFP act
// snap is applied to each tile between its load and the product.
//
// What bounds it on an H100: at the main paths' shapes (M = 8 decode and
// temb rows, M = 128..8192 conv pixels, K <= 4608) the work is far too
// small for the card: the bytes bound is well under a microsecond and the
// product a few GFLOP at most, so latency and SM occupancy decide. The
// previous body (a 64x64 SIMT f32 tile walking all of K serially) left
// most of the 132 SMs idle at small M and ran no tensor core. This one:
//
//  * Tensor cores on exact operands. mma.sync m16n8k16 bf16 x bf16 -> f32.
//    The weight operand is the decoded grid magnitude (a 16-entry LUT per
//    launch; every 4-bit ExMy magnitude is exact in bf16); its per-column
//    scale * rcp(base_max) multiplies the f32 accumulator in the epilogue.
//    The act operand is, by mode: GRID (f32 input, signed snap) the signed
//    grid point +-g, the act scale applied in the epilogue; BF16 (bf16
//    input) the bf16 x_q itself; SPLIT3 (f32 input, unsigned snap or act
//    off) x_q split exactly into three bf16 terms hi + mid + lo, three MMAs.
//    Products are exact, so the kernel differs from its plain version only
//    by per-term roundings of the scales and the order of the f32 sums: with
//    power-of-two scales and grid acts (W4A4 at act maxval 6) both sum
//    exactly and agree bit for bit. The decoded weight is never rounded to
//    bf16 after scaling (the Pallas kernels' bf16 behaviour, which the port
//    does not follow: tests/test_torch_kernels.py pins it).
//  * Three tile shapes. LARGE: 128 act rows x 128 weight columns, 8 warps
//    of 64x32; MEDIUM: 64 x 64, 8 warps of 32x16 (more blocks where LARGE
//    leaves SMs idle, and short per-step chains where latency rules);
//    SMALL (M <= 8): y^T = W^T x^T, the weight columns on the MMA's 16-row
//    side and 8 tokens on its n = 8 side, 4 warps of 16 columns x 8 tokens,
//    so no row is padded from 8 to 64. BK = 32.
//  * One fetch per packed byte: a block owns columns j and j + N/2, the
//    two nibbles of one byte (the TPU kernel's h grid axis), and decodes
//    both from one load.
//  * A 3-stage cp.async ring of 16-byte copies of the raw act tile and the
//    packed bytes (zero-filled out of range), snapped and decoded from
//    shared memory into one of two bf16 operand buffers while the product
//    reads the other and the next stages are in flight (one barrier a
//    step). Shapes whose rows are not 16-byte aligned load the same ring
//    element by element.
//  * Deterministic split-K: the caller (kernels/w4_matmul.py:gemm_plan)
//    splits K so that small-M launches fill the card; each split writes
//    its f32 partial to a workspace and a second kernel sums the splits
//    in split order. No float atomics: the order never changes.
//
// Out-of-range rows, columns and k (and K3's taps outside the image) read
// exact zero after the snap, which is the quantize-then-pad order of the
// reference and keeps them out of the zero-point row sum. wgmma/TMA are
// not used: the act snap transforms every A tile between its load and the
// product and K3's A tile is a gather, and at these sizes the gap to the
// bound is set by occupancy and latency, not by the last 30% of the
// tensor-core rate that wgmma adds over mma.sync.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "msfp.cuh"

namespace w4gemm {

enum Mode { GRID = 0, BF16 = 1, SPLIT3 = 2 };

// Tile shapes (act rows, packed byte columns, k step, threads) come from
// kernels/build.py:GEMM_TILES as -DW4_TILE<cfg>_{ROWS,BJ,BK,NT}, cfg 0 =
// Large, 1 = Small, 2 = Medium; the wrappers plan launches with the same
// table.
#if !defined(W4_TILE0_ROWS) || !defined(W4_TILE1_ROWS) || \
    !defined(W4_TILE2_ROWS)
#error "build with kernels/build.py, which passes the tile shapes"
#endif
// WM x WN warps, each MT m16 tiles of act rows by NTL n8 tiles of columns.
struct Large {
  static constexpr bool SWAP = false;
  static constexpr int ROWS = W4_TILE0_ROWS, BJ = W4_TILE0_BJ,
                       BK = W4_TILE0_BK, NT = W4_TILE0_NT;
  static constexpr int WM = 2, WN = 4, MT = 4, NTL = 4;  // warp 64 x 32
};
struct Medium {
  static constexpr bool SWAP = false;
  static constexpr int ROWS = W4_TILE2_ROWS, BJ = W4_TILE2_BJ,
                       BK = W4_TILE2_BK, NT = W4_TILE2_NT;
  static constexpr int WM = 2, WN = 4, MT = 2, NTL = 2;  // warp 32 x 16
};
struct Small {   // y^T = W^T x^T: weight columns on the MMA's 16-row side
  static constexpr bool SWAP = true;
  static constexpr int ROWS = W4_TILE1_ROWS, BJ = W4_TILE1_BJ,
                       BK = W4_TILE1_BK, NT = W4_TILE1_NT;
  static constexpr int WM = 1, WN = 4, MT = 1, NTL = 1;  // warp 16 x 8
  static_assert(ROWS == 8 && WN * 16 == 2 * BJ && WN * 32 == NT,
                "one n8 tile of acts, a warp per 16 weight columns");
};
constexpr int STAGES = 3;

// ---- PTX helpers -----------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// ---- shared-memory layout --------------------------------------------
template <class C, typename T, int MODE> struct Smem {
  static constexpr int NTERMS = MODE == SPLIT3 ? 3 : 1;
  static constexpr int COLS = 2 * C::BJ;      // weight columns of a block
  static constexpr int OPS = C::BK + 8;       // operand row stride (bf16)
  static constexpr int RXS = C::BK * (int)sizeof(T) + 16;  // raw act row (B)
  static constexpr int RWS = C::BJ;                        // raw byte row
  static constexpr int RAW_X = C::ROWS * RXS;
  static constexpr int RAW_W = C::BK * RWS;
  static constexpr int STAGE = RAW_X + RAW_W;
  // operand tiles, two of each: step i's product reads one while step
  // i+1's snap and decode write the other
  static constexpr int XS_BUF = NTERMS * C::ROWS * OPS;   // bf16 elements
  static constexpr int WS_BUF = COLS * OPS;
  static constexpr int OFF_XS = STAGES * STAGE;
  static constexpr int OFF_WS = OFF_XS + 2 * XS_BUF * 2;
  static constexpr int OFF_ROW = OFF_WS + 2 * WS_BUF * 2;   // 3 ints a row
  static constexpr int OFF_SUM = OFF_ROW + 3 * C::ROWS * 4;
  static constexpr int OFF_LUT = OFF_SUM + C::ROWS * 4;
  static constexpr int OFF_SC = OFF_LUT + 16 * 2;   // a column's scale, zp
  static constexpr int OFF_ZP = OFF_SC + COLS * 4;
  static constexpr int BYTES = OFF_ZP + COLS * 4;
};

// The weight-format constants of a launch (a packed (K, N/2) u8 operand).
struct WArgs {
  msfp::WQ wq;
  int N, K;
};

// ---- the kernel ------------------------------------------------------
template <typename T, int MODE, class C, class ALoad>
__global__ void __launch_bounds__(C::NT)
w4_gemm_kernel(ALoad a, WArgs w, int M, int steps_per_split,
               float* __restrict__ ws, T* __restrict__ out) {
  using S = Smem<C, T, MODE>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem + S::OFF_XS);
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem + S::OFF_WS);
  int* rowinfo = reinterpret_cast<int*>(smem + S::OFF_ROW);
  float* rowsum_s = reinterpret_cast<float*>(smem + S::OFF_SUM);
  __nv_bfloat16* lut = reinterpret_cast<__nv_bfloat16*>(smem + S::OFF_LUT);
  float* sc_s = reinterpret_cast<float*>(smem + S::OFF_SC);
  float* zp_s = reinterpret_cast<float*>(smem + S::OFF_ZP);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = w.N, K = w.K, half = N / 2;
  const int j0 = blockIdx.x * C::BJ, m0 = blockIdx.y * C::ROWS;
  const int steps = (K + C::BK - 1) / C::BK;
  const int kbeg = blockIdx.z * steps_per_split;
  const int nsteps = min(steps_per_split, steps - kbeg);
  const bool zp_on = !w.wq.is_signed;
  const bool w_vec = (half % 16 == 0) &&
                     ((reinterpret_cast<uintptr_t>(w.wq.packed) & 15) == 0);

  msfp::ActQ q;

  auto stage_x = [&](int s) { return smem + s * S::STAGE; };
  auto stage_w = [&](int s) { return smem + s * S::STAGE + S::RAW_X; };

  auto load_stage = [&](int s, int step) {
    const int k0 = step * C::BK;
    a.template load<C::ROWS, C::BK, S::RXS, C::NT>(stage_x(s), rowinfo, m0,
                                                    k0, tid);
    unsigned char* rw = stage_w(s);
    if (w_vec) {
      constexpr int CPR = C::BJ / 16;
      for (int c = tid; c < C::BK * CPR; c += C::NT) {
        const int kk = c / CPR, q16 = c % CPR, k = k0 + kk, j = j0 + q16 * 16;
        const bool ok = k < K && j < half;
        cp_async16(rw + kk * S::RWS + q16 * 16,
                   ok ? w.wq.packed + (size_t)k * half + j : w.wq.packed, ok);
      }
    } else {
      for (int e = tid; e < C::BK * C::BJ; e += C::NT) {
        const int kk = e / C::BJ, jj = e % C::BJ, k = k0 + kk, j = j0 + jj;
        rw[kk * S::RWS + jj] =
            (k < K && j < half) ? w.wq.packed[(size_t)k * half + j] : 0;
      }
    }
  };

  // act transform: a thread owns KPT consecutive k of one row
  constexpr int TPR = C::NT / C::ROWS, KPT = C::BK / TPR;
  const int tr = tid / TPR, tk = (tid % TPR) * KPT;
  float rsum = 0.f;
  auto transform = [&](int s, int step, int buf) {
    __nv_bfloat16* xo = Xs + buf * S::XS_BUF;
    __nv_bfloat16* wo = Ws + buf * S::WS_BUF;
    const int k = step * C::BK + tk, m = m0 + tr;
    const unsigned vm = a.valid_mask(rowinfo, tr, m, k, KPT);
    const T* src = reinterpret_cast<const T*>(stage_x(s) + tr * S::RXS) + tk;
    uint32_t t0[KPT / 2], t1[KPT / 2], t2[KPT / 2];
#pragma unroll
    for (int i = 0; i < KPT; i += 2) {
      float g[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = (vm >> (i + e)) & 1u;
        const float v = msfp::to_f<T>(src[i + e]);
        if (MODE == GRID) {   // f32 input, signed snap: +-g, scale later
          const float gm = msfp::snap_base(__fmul_rn(fabsf(v), q.inv),
                                           q.exp_bits, q.man_bits, q.bmax);
          g[e] = ok ? (v < 0.f ? -gm : gm) : 0.f;
        } else {
          const float x = a.enabled ? msfp::round_to<T>(q(v)) : v;
          g[e] = ok ? x : 0.f;
        }
        // the zero-point's row sum runs over x_q: sign(x) * (g * scale)
        if (zp_on)
          rsum = __fadd_rn(rsum, MODE == GRID ? __fmul_rn(g[e], q.scale)
                                              : g[e]);
      }
      if (MODE == SPLIT3) {   // x = hi + mid + lo, each exact in bf16
        float hi[2], mid[2], lo[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          hi[e] = __bfloat162float(__float2bfloat16_rn(g[e]));
          const float r = __fsub_rn(g[e], hi[e]);
          mid[e] = __bfloat162float(__float2bfloat16_rn(r));
          lo[e] = __fsub_rn(r, mid[e]);
        }
        t0[i / 2] = pack_bf16(hi[0], hi[1]);
        t1[i / 2] = pack_bf16(mid[0], mid[1]);
        t2[i / 2] = pack_bf16(lo[0], lo[1]);
      } else {
        t0[i / 2] = pack_bf16(g[0], g[1]);
      }
    }
#pragma unroll
    for (int t = 0; t < S::NTERMS; ++t) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          xo + (t * C::ROWS + tr) * S::OPS + tk);
      const uint32_t* v = t == 0 ? t0 : (t == 1 ? t1 : t2);
#pragma unroll
      for (int i = 0; i < KPT / 2; ++i) dst[i] = v[i];
    }

    // weights: a thread owns 8 consecutive k of one byte column j and
    // writes both nibbles' columns (j and BJ + j of the tile)
    constexpr int KPW = C::BK * C::BJ / C::NT;
    static_assert(KPW == 4 || KPW == 8, "4 or 8 bytes a thread");
    const int jj = tid % C::BJ, kk0 = (tid / C::BJ) * KPW;
    const unsigned char* rw = stage_w(s);
    uint32_t lo4[KPW / 2], hi4[KPW / 2];
#pragma unroll
    for (int i = 0; i < KPW; i += 2) {
      const unsigned b0 = rw[(kk0 + i) * S::RWS + jj];
      const unsigned b1 = rw[(kk0 + i + 1) * S::RWS + jj];
      lo4[i / 2] = (uint32_t)__bfloat16_as_ushort(lut[b0 & 15]) |
                   ((uint32_t)__bfloat16_as_ushort(lut[b1 & 15]) << 16);
      hi4[i / 2] = (uint32_t)__bfloat16_as_ushort(lut[b0 >> 4]) |
                   ((uint32_t)__bfloat16_as_ushort(lut[b1 >> 4]) << 16);
    }
    if constexpr (KPW == 8) {
      *reinterpret_cast<uint4*>(wo + jj * S::OPS + kk0) =
          make_uint4(lo4[0], lo4[1], lo4[2], lo4[3]);
      *reinterpret_cast<uint4*>(wo + (C::BJ + jj) * S::OPS + kk0) =
          make_uint4(hi4[0], hi4[1], hi4[2], hi4[3]);
    } else {
      *reinterpret_cast<uint2*>(wo + jj * S::OPS + kk0) =
          make_uint2(lo4[0], lo4[1]);
      *reinterpret_cast<uint2*>(wo + (C::BJ + jj) * S::OPS + kk0) =
          make_uint2(hi4[0], hi4[1]);
    }
  };

  // accumulators: an MT x NTL grid of m16n8 tiles a warp (SMALL: one)
  constexpr int AM = C::MT, AN = C::NTL;
  static_assert(C::SWAP || (C::WM * C::MT * 16 == C::ROWS &&
                            C::WN * C::NTL * 8 == 2 * C::BJ &&
                            C::WM * C::WN * 32 == C::NT),
                "warp grid must tile the block");
  float acc[AM][AN][4];
#pragma unroll
  for (int i = 0; i < AM; ++i)
#pragma unroll
    for (int j = 0; j < AN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // GRID products (an act grid point times a weight grid magnitude) are
  // short dyadic numbers that sum exactly in the tensor core's
  // accumulator at these K; the other modes' operands span many
  // octaves, where the accumulator's alignment truncates each product sum
  // toward zero, a bias that grows with K. They take each MMA's sum from a
  // zeroed accumulator and add it with an IEEE f32 add, as an f32 GEMM
  // would add the 16-term chunk.
  auto mma_acc = [&](float (&c)[4], const uint32_t (&fa)[4],
                     const uint32_t (&fb)[2]) {
    if constexpr (MODE == GRID) {
      mma_bf16(c, fa, fb);
    } else {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(d, fa, fb);
#pragma unroll
      for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(c[e], d[e]);
    }
  };
  auto mma_step = [&](int buf) {
    const __nv_bfloat16* xo = Xs + buf * S::XS_BUF;
    const __nv_bfloat16* wo = Ws + buf * S::WS_BUF;
#pragma unroll
    for (int ks = 0; ks < C::BK; ks += 16) {
      if constexpr (C::SWAP) {
        uint32_t fa[4];
        ldmatrix_x4(fa, wo + (warp * 16 + (lane & 15)) * S::OPS + ks +
                            (lane >> 4) * 8);
#pragma unroll
        for (int t = 0; t < S::NTERMS; ++t) {
          uint32_t fb[2];
          ldmatrix_x2(fb, xo + (t * C::ROWS + (lane & 7)) * S::OPS + ks +
                              ((lane >> 3) & 1) * 8);
          mma_acc(acc[0][0], fa, fb);
        }
      } else {
        const int wm = warp / C::WN, wn = warp % C::WN;
        uint32_t fb[AN][2];
#pragma unroll
        for (int nt = 0; nt < AN; ++nt)
          ldmatrix_x2(fb[nt], wo + (wn * AN * 8 + nt * 8 + (lane & 7)) *
                                       S::OPS +
                                  ks + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int t = 0; t < S::NTERMS; ++t)
#pragma unroll
          for (int mt = 0; mt < AM; ++mt) {
            uint32_t fa[4];
            ldmatrix_x4(fa, xo + (t * C::ROWS + wm * AM * 16 + mt * 16 +
                                  (lane & 15)) * S::OPS +
                                ks + (lane >> 4) * 8);
#pragma unroll
            for (int nt = 0; nt < AN; ++nt) mma_acc(acc[mt][nt], fa, fb[nt]);
          }
      }
    }
  };

  // the ring: stage i % STAGES holds step kbeg + i. The first copies go
  // out before the launch constants are read, so their global loads
  // overlap; then one barrier a step: step i's product and step i+1's
  // snap and decode share it, on the two operand buffers.
  a.prep(rowinfo, m0, C::ROWS, tid, C::NT);
  __syncthreads();   // rowinfo, for the copies' addresses
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load_stage(s, kbeg + s);
    cp_async_commit();
  }
  // the weight format's 16 signed grid magnitudes, exact in bf16
  if (tid < 16) {
    const int nbits = w.wq.exp_bits + w.wq.man_bits;
    int code = tid, sign = 0;
    if (w.wq.is_signed) {
      sign = (code >> nbits) & 1;
      code &= (1 << nbits) - 1;
    }
    const float mag = msfp::decode_mag(code, w.wq.exp_bits, w.wq.man_bits);
    lut[tid] = __float2bfloat16_rn(sign ? -mag : mag);
  }
  // the block's columns' scale * rcp(base_max) and zero-point, read once
  // here: read in the epilogue they would wait behind its stores
  const float rcp_bmax = __frcp_rn(msfp::base_max(w.wq.exp_bits,
                                                  w.wq.man_bits));
  for (int p = tid; p < S::COLS; p += C::NT) {
    const int jj = p % C::BJ, n = (p < C::BJ ? 0 : half) + j0 + jj;
    const bool ok = j0 + jj < half;
    sc_s[p] = ok ? __fmul_rn(__ldg(w.wq.scale + n * w.wq.scale_stride),
                             rcp_bmax) : 0.f;
    zp_s[p] = ok && zp_on ? __ldg(w.wq.zp + n * w.wq.scale_stride) : 0.f;
  }
  a.load_q(q);
  if (nsteps > 0) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // step 0 landed; the LUT and scales are visible
    transform(0, kbeg, 0);
  }
  for (int i = 0; i < nsteps; ++i) {
    if (i + STAGES - 1 < nsteps)
      load_stage((i + STAGES - 1) % STAGES, kbeg + i + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 2>();
    // step i's operands are complete, step i+1's copies landed, and every
    // warp is done with step i-1's product (the buffer step i+1 refills)
    __syncthreads();
    mma_step(i & 1);
    if (i + 1 < nsteps)
      transform((i + 1) % STAGES, kbeg + i + 1, (i + 1) & 1);
  }
  cp_async_wait<0>();

  if (zp_on) {   // the row's partial sums, in a fixed lane order
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1)
      rsum = __fadd_rn(rsum, __shfl_xor_sync(0xffffffffu, rsum, o));
    if (tid % TPR == 0) rowsum_s[tr] = rsum;
  }
  __syncthreads();

  const float a_scale = MODE == GRID ? q.scale : 1.f;
  const bool split = gridDim.z > 1;
  auto fin = [&](int r, int p, float v) {
    v = __fmul_rn(__fmul_rn(v, a_scale), sc_s[p]);
    return zp_on ? __fadd_rn(v, __fmul_rn(rowsum_s[r], zp_s[p])) : v;
  };
  auto emit = [&](int r, int p, float v) {
    const int m = m0 + r, jj = p % C::BJ;
    if (m >= M || j0 + jj >= half) return;
    const int n = (p < C::BJ ? 0 : half) + j0 + jj;
    v = fin(r, p, v);
    if (split)
      ws[((size_t)blockIdx.z * M + m) * N + n] = v;
    else
      out[(size_t)m * N + n] = msfp::from_f<T>(v);
  };
  // columns p and p + 1 (p even: both in the same half) of row r
  auto emit2 = [&](int r, int p, float v0, float v1) {
    const int m = m0 + r, jj = p % C::BJ;
    const int n = (p < C::BJ ? 0 : half) + j0 + jj;
    if (m >= M || j0 + jj + 1 >= half || (n & 1)) {
      emit(r, p, v0);
      emit(r, p + 1, v1);
      return;
    }
    v0 = fin(r, p, v0);
    v1 = fin(r, p + 1, v1);
    if (split) {
      *reinterpret_cast<float2*>(ws + ((size_t)blockIdx.z * M + m) * N + n) =
          make_float2(v0, v1);
    } else if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(out + (size_t)m * N + n) =
          make_float2(v0, v1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) =
          __floats2bfloat162_rn(v0, v1);
    }
  };
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  if constexpr (C::SWAP) {
    // C[col p][token]: c0/c1 at col g, c2/c3 at col g + 8
#pragma unroll
    for (int e = 0; e < 4; ++e)
      emit(q2 + (e & 1), warp * 16 + g + (e >> 1) * 8, acc[0][0][e]);
  } else {
    const int wm = warp / C::WN, wn = warp % C::WN;
#pragma unroll
    for (int mt = 0; mt < AM; ++mt)
#pragma unroll
      for (int nt = 0; nt < AN; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          emit2(wm * AM * 16 + mt * 16 + g + h * 8, wn * AN * 8 + nt * 8 + q2,
                acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  }
}

// out[i] = sum over splits of ws[s][i], in split order. ALoad only names
// the instance after its kernel (K2 or K3) in a profile.
template <typename T, class ALoad>
__global__ void splitk_reduce(const float* __restrict__ ws, int splits,
                              size_t mn, T* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = ws[i];
    for (int s = 1; s < splits; ++s) v = __fadd_rn(v, ws[s * mn + i]);
    out[i] = msfp::from_f<T>(v);
  }
}

template <typename T, int MODE, class C, class ALoad>
int launch_cfg(const ALoad& a, const WArgs& w, int M, int splits, float* ws,
               T* out, cudaStream_t s) {
  using S = Smem<C, T, MODE>;
  auto kern = w4_gemm_kernel<T, MODE, C, ALoad>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int steps = (w.K + C::BK - 1) / C::BK;
  const int per = (steps + splits - 1) / splits;
  dim3 grid((w.N / 2 + C::BJ - 1) / C::BJ, (M + C::ROWS - 1) / C::ROWS,
            splits);
  if (grid.y > 65535 || splits > 65535) return (int)cudaErrorInvalidConfiguration;
  kern<<<grid, C::NT, S::BYTES, s>>>(a, w, M, per, ws, out);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t mn = (size_t)M * w.N;
  const int blocks = (int)((mn + 255) / 256 < 1024 ? (mn + 255) / 256 : 1024);
  splitk_reduce<T, ALoad><<<blocks, 256, 0, s>>>(ws, splits, mn, out);
  return (int)cudaGetLastError();
}

// cfg 0 = Large, 1 = Small, 2 = Medium; splits >= 1, every split non-empty
// (kernels/w4_matmul.py:gemm_plan); ws holds splits * M * N f32 when
// splits > 1.
template <typename T, int MODE, class ALoad>
int launch_mode(const ALoad& a, const WArgs& w, int M, int cfg, int splits,
                float* ws, T* out, cudaStream_t s) {
  if (cfg == 0)
    return launch_cfg<T, MODE, Large>(a, w, M, splits, ws, out, s);
  if (cfg == 2)
    return launch_cfg<T, MODE, Medium>(a, w, M, splits, ws, out, s);
  return launch_cfg<T, MODE, Small>(a, w, M, splits, ws, out, s);
}

template <typename T, class ALoad>
int launch(const ALoad& a, const msfp::WQ& wq, int M, int N, int K, int cfg,
           int splits, void* ws, T* out, cudaStream_t s) {
  if (M <= 0 || N <= 0) return 0;
  static_assert(Large::BK == Small::BK && Medium::BK == Small::BK,
                "one k step for every tile");
  if (cfg < 0 || cfg > 2 || splits < 1 || N % 2)
    return (int)cudaErrorInvalidValue;
  const int bk = Large::BK;
  const int steps = (K + bk - 1) / bk;
  if (steps == 0 ? splits != 1
                 : (splits > steps ||
                    (splits - 1) * ((steps + splits - 1) / splits) >= steps))
    return (int)cudaErrorInvalidValue;   // an empty split
  if (splits > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const WArgs w{wq, N, K};
  float* wsf = static_cast<float*>(ws);
  if constexpr (sizeof(T) == 2) {
    return launch_mode<T, BF16>(a, w, M, cfg, splits, wsf, out, s);
  } else {
    if (a.enabled && a.is_signed)
      return launch_mode<T, GRID>(a, w, M, cfg, splits, wsf, out, s);
    return launch_mode<T, SPLIT3>(a, w, M, cfg, splits, wsf, out, s);
  }
}

}  // namespace w4gemm
