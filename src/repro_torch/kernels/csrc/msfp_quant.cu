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
                                int is_signed, int folded) {
  msfp::ActQ q;
  q.load(maxval, zp, exp_bits, man_bits, is_signed);
  if (folded) q.fold_scale(maxval);
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
                               int folded, int dtype, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    msfp_qdq_kernel<float><<<(int)blocks, threads, 0, s>>>(
        (const float*)x, (float*)out, n, (const float*)maxval,
        (const float*)zp, exp_bits, man_bits, is_signed, folded);
  } else if (dtype == 1) {
    msfp_qdq_kernel<__nv_bfloat16><<<(int)blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)out, n, (const float*)maxval,
        (const float*)zp, exp_bits, man_bits, is_signed, folded);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// qdq_conv2d: the io sites' act snap, dense f32 conv and bias in one launch,
// y = conv_NHWC(pad(snap(x)), W) + b at stride 1, kh = kw in {1, 3}.
//
// Replaces K1 at the io sites, src/repro/kernels/msfp_quant.py:msfp_qdq_2d,
// fused with the XLA conv that follows it there (src/repro/nn/layers.py:106).
// K1 alone cannot come near its bound at these sizes: a launch costs the
// card about 2 us whatever it does, and at conv_out it wrote a snapped
// (B*H*W, 128) f32 copy to device memory that the conv read straight back.
// Here the snapped act never leaves shared memory, and the conv, the bias
// and the layout glue around them are the same launch.
//
// Bound: bytes. At full width (B 8, 32x32) each site moves about 4.3 MB
// (conv_in writes 4.2 MB, conv_out reads 4.2 MB), 1.28 us at 3.35 TB/s,
// against 57 MFLOP of f32 FMA (0.85 us at 67 TFLOP/s), so SIMT f32 is
// enough and tensor cores buy nothing.
//
// Design: one CTA per (image, band of `rows` output rows), 256 threads.
//   * The band's input halo, (rows + k - 1) x (OW + k - 1) pixels of cin,
//     is staged in shared memory once (cp.async, all of a thread's copies
//     in flight at once) and each element snapped once, in place, by the
//     thread that copied it (the TPU kernels' snap-once property). Pad
//     positions are written as exact 0 and never snapped: the reference
//     quantizes, then pads, and an unsigned snap of 0 with zp != 0 is
//     not 0.
//   * The weights (13.8 KB at both io sites) and the bias go to shared
//     memory too, converted exactly to f32.
//   * Each output is one f32 FMA chain from zero over the taps in
//     (ki, kj, c) order, the order of the CPU's conv at these shapes (the
//     io sites' outputs equal the CPU's bit for bit); the bias is added to
//     the finished sum, never seeding it.
//   * wide (cout % 4 == 0; conv_in, 3 -> 128, K = 27): a thread owns 4
//     neighbouring output channels of WIDE_PIX pixels; a warp's 32 threads
//     cover 128 channels of the same pixels, so each act read is a
//     broadcast, each weight read one 16-byte load, and the stores are
//     coalesced float4s. Weights keep the HWIO layout, pixels a stride of
//     cin | 1 floats.
//   * narrow (otherwise; conv_out, 128 -> 3, K = 1152): a thread owns the
//     min(cout, 4) channels of one pixel, so each act read serves all its
//     chains and each weight read is a broadcast; the chains read 4 taps at
//     a time (16-byte loads, cin % 4 == 0) two steps ahead of their FMAs,
//     from channel-major weight rows; act and weight strides are padded to
//     an odd count of 16-byte words so neighbouring pixels hit distinct
//     banks.
// What bounds it on an H100 is not the device memory. At conv_out a 2-row
// band is 64 pixels, so a CTA runs two warps of chains 1152 long, and the
// shared-memory reads that feed them (the weights' broadcasts included)
// and their latency set the time; staging and snapping a halo of twice
// the band's rows costs about as much again. A faster kernel would
// pipeline the halo rows against the chains.
// The launch takes the layout (rows, pixel and weight strides, dynamic
// shared memory) from kernels/msfp_quant.py:io_conv_layout, the one formula
// that sizes it, and refuses a layout that would not hold the band.
namespace {

constexpr int CONV_THREADS = 256;
constexpr int WIDE_PIX = 8;       // pixels a thread in the wide kernel
constexpr int WEIGHT_BATCH = 16;  // weight loads a thread keeps in flight

struct ConvArgs {
  const float* x;
  const void* w;
  const float* bias;
  float* out;
  int h, wd, cin, cout, oh, ow, k, ph0, pw0, rows, cs, ks;
};

// Shared memory, in floats: the halo, the weights, the bias (each rounded
// up to 16 bytes; kernels/msfp_quant.py:io_conv_layout is the same sum).
__device__ __forceinline__ int xs_floats(const ConvArgs& a) {
  return ((a.rows + a.k - 1) * (a.ow + a.k - 1) * a.cs + 3) & ~3;
}

__device__ __forceinline__ int ws_floats(const ConvArgs& a, bool wide,
                                         int nc) {
  return wide ? a.k * a.k * a.cin * a.cout
              : (((a.cout + nc - 1) / nc * nc * a.ks + 3) & ~3);
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  }
}

// A thread's walk over the halo's chunks (vec floats of one pixel): chunk
// t, t + T, ... of the (halo row, column, chunk) order, advanced without a
// division (integer division by a run-time value is a long dependent
// chain, and the walk is the staging's inner loop).
struct HaloWalk {
  int per_pix, wp, dp, dc;  // chunks a pixel, halo width, step in pixels+chunks
  int r, col, c;            // where the thread is: halo row, column, chunk

  __device__ __forceinline__ HaloWalk(int per_pix_, int wp_) {
    per_pix = per_pix_;
    wp = wp_;
    const int T = blockDim.x, t = threadIdx.x;
    dp = T / per_pix;
    dc = T - dp * per_pix;
    const int pix = t / per_pix;
    c = t - pix * per_pix;
    r = pix / wp;
    col = pix - r * wp;
  }

  __device__ __forceinline__ void next() {
    c += dc;
    col += dp;
    if (c >= per_pix) {
      c -= per_pix;
      ++col;
    }
    while (col >= wp) {
      col -= wp;
      ++r;
    }
  }
};

// The band's halo into xs[(r * wp + col) * cs + c], the weights into ws
// (HWIO for the wide kernel, channel-major rows ks floats apart for the
// narrow one) and the bias into bs, all as f32. No load may wait for
// another: the halo goes by cp.async (16 bytes where cin and cs allow,
// else 4), all of a thread's copies in flight at once, while its weights
// come WEIGHT_BATCH loads at a time through registers. Pads are stored as
// exact 0. The copies are complete for the thread itself on return
// (cp.async.wait_all); the caller's barrier publishes them.
template <typename T, bool WIDE, int NC>
__device__ __forceinline__ void stage(const ConvArgs& a, float* xs, float* ws,
                                      float* bs, int b, int r0, int nr) {
  const int wp = a.ow + a.k - 1, hr = nr + a.k - 1;
  const int ih0 = r0 - a.ph0, iw0 = -a.pw0;
  const float* xb = a.x + (long long)b * a.h * a.wd * a.cin;
  const int vec = (a.cin % 4 == 0 && a.cs % 4 == 0) ? 4 : 1;
  for (HaloWalk it(a.cin / vec, wp); it.r < hr; it.next()) {
    const int ih = ih0 + it.r, iw = iw0 + it.col;
    float* d = xs + (it.r * wp + it.col) * a.cs + it.c * vec;
    if (ih >= 0 && ih < a.h && iw >= 0 && iw < a.wd) {
      cp_async(d, xb + ((long long)ih * a.wd + iw) * a.cin + it.c * vec,
               4 * vec);
    } else if (vec == 4) {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      *d = 0.f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);

  const T* w = (const T*)a.w;
  const int kdim = a.k * a.k * a.cin;
  // narrow: (co, kk) over the channel rows padded to a multiple of NC, the
  // padding rows zero
  const int nw = kdim * (WIDE ? a.cout : (a.cout + NC - 1) / NC * NC);
  for (int base = threadIdx.x; base < nw; base += WEIGHT_BATCH * blockDim.x) {
    float v[WEIGHT_BATCH];
#pragma unroll
    for (int j = 0; j < WEIGHT_BATCH; ++j) {
      const int i = base + j * blockDim.x;
      if (WIDE) {
        v[j] = i < nw ? msfp::to_f<T>(w[i]) : 0.f;
      } else {   // i walks ws's order: (co, kk) -> w[kk * cout + co]
        const int co = i / kdim;
        v[j] = i < nw && co < a.cout
                   ? msfp::to_f<T>(w[(i - co * kdim) * a.cout + co]) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < WEIGHT_BATCH; ++j) {
      const int i = base + j * blockDim.x;
      if (i >= nw) break;
      if (WIDE) {
        ws[i] = v[j];
      } else {
        const int co = i / kdim;
        ws[co * a.ks + i - co * kdim] = v[j];
      }
    }
  }
  if (a.bias) {
    for (int i = threadIdx.x; i < a.cout; i += blockDim.x) bs[i] = a.bias[i];
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

// The thread's own halo copies (stage's walk), snapped in place, 4 at a
// time where they came 16 bytes at a time; pads are not snapped.
__device__ __forceinline__ void snap_own(const ConvArgs& a, float* xs, int r0,
                                         int nr, const msfp::ActQ& q) {
  const int wp = a.ow + a.k - 1, hr = nr + a.k - 1;
  const int ih0 = r0 - a.ph0, iw0 = -a.pw0;
  const int vec = (a.cin % 4 == 0 && a.cs % 4 == 0) ? 4 : 1;
  for (HaloWalk it(a.cin / vec, wp); it.r < hr; it.next()) {
    const int ih = ih0 + it.r, iw = iw0 + it.col;
    if (ih < 0 || ih >= a.h || iw < 0 || iw >= a.wd) continue;
    float* d = xs + (it.r * wp + it.col) * a.cs + it.c * vec;
    if (vec == 4) {
      float4 v = *reinterpret_cast<float4*>(d);
      v.x = q(v.x);
      v.y = q(v.y);
      v.z = q(v.z);
      v.w = q(v.w);
      *reinterpret_cast<float4*>(d) = v;
    } else {
      *d = q(*d);
    }
  }
}

// One (ki, kj) segment of a narrow thread's NC chains: n4 16-byte steps
// of its pixel's act (x4) and of each channel's weight row (w4, ks4 words
// apart), in tap order. A chain is a string of dependent FMAs, so each
// step's reads are issued two steps ahead of its FMAs.
template <int NC>
__device__ __forceinline__ void narrow_segment(const float4* x4,
                                               const float4* w4, int ks4,
                                               int n4, float (&acc)[NC]) {
  float4 xa = x4[0], xb = n4 > 1 ? x4[1] : xa, wa[NC], wb[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    wa[q] = w4[q * ks4];
    wb[q] = n4 > 1 ? w4[q * ks4 + 1] : wa[q];
  }
  for (int i = 0; i < n4; ++i) {
    const int nx = i + 2 < n4 ? i + 2 : i;   // the step two ahead
    const float4 xc = x4[nx];
    float4 wc[NC];
#pragma unroll
    for (int q = 0; q < NC; ++q) wc[q] = w4[q * ks4 + nx];
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      acc[q] = __fmaf_rn(xa.x, wa[q].x, acc[q]);
      acc[q] = __fmaf_rn(xa.y, wa[q].y, acc[q]);
      acc[q] = __fmaf_rn(xa.z, wa[q].z, acc[q]);
      acc[q] = __fmaf_rn(xa.w, wa[q].w, acc[q]);
    }
    xa = xb;
    xb = xc;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      wa[q] = wb[q];
      wb[q] = wc[q];
    }
  }
}

template <typename T, bool WIDE, int NC>
__global__ void __launch_bounds__(CONV_THREADS)
qdq_conv2d_kernel(ConvArgs a, const float* maxval, const float* zp,
                  int exp_bits, int man_bits, int is_signed, int has_act) {
  extern __shared__ __align__(16) float smem[];
  const int bands = (a.oh + a.rows - 1) / a.rows;
  const int b = blockIdx.x / bands;
  const int r0 = (blockIdx.x - b * bands) * a.rows;
  const int nr = min(a.rows, a.oh - r0);
  const int wp = a.ow + a.k - 1;
  float* xs = smem;
  float* ws = xs + xs_floats(a);
  float* bs = ws + ws_floats(a, WIDE, NC);
  float mv = 0.f, z = 0.f;   // in flight while the band is staged
  if (has_act) {
    mv = __ldg(maxval);
    z = __ldg(zp);
  }
  stage<T, WIDE, NC>(a, xs, ws, bs, b, r0, nr);
  if (has_act) {
    msfp::ActQ q;
    q.load(&mv, &z, exp_bits, man_bits, is_signed);
    snap_own(a, xs, r0, nr, q);
  }
  __syncthreads();

  const int npix = nr * a.ow;
  float* ob = a.out + ((long long)b * a.oh + r0) * a.ow * a.cout;
  if (WIDE) {
    const int c4n = a.cout / 4;
    const int ng = (npix + WIDE_PIX - 1) / WIDE_PIX;  // pixel groups
    for (int u = threadIdx.x; u < ng * c4n; u += blockDim.x) {
      const int pg = u / c4n, co = (u - pg * c4n) * 4;
      const float* xp[WIDE_PIX];
      float acc[WIDE_PIX][4];
#pragma unroll
      for (int j = 0; j < WIDE_PIX; ++j) {
        // a tail pixel reads pixel npix - 1 and is not stored
        const int p = min(pg + j * ng, npix - 1);
        const int r = p / a.ow;
        xp[j] = xs + (r * wp + p - r * a.ow) * a.cs;
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      }
      for (int ki = 0; ki < a.k; ++ki) {
        for (int kj = 0; kj < a.k; ++kj) {
          const int xo = (ki * wp + kj) * a.cs;
          const float* wr = ws + (ki * a.k + kj) * a.cin * a.cout + co;
#pragma unroll 4
          for (int c = 0; c < a.cin; ++c) {
            const float4 wv = *reinterpret_cast<const float4*>(wr + c * a.cout);
#pragma unroll
            for (int j = 0; j < WIDE_PIX; ++j) {
              const float xv = xp[j][xo + c];
              acc[j][0] = __fmaf_rn(xv, wv.x, acc[j][0]);
              acc[j][1] = __fmaf_rn(xv, wv.y, acc[j][1]);
              acc[j][2] = __fmaf_rn(xv, wv.z, acc[j][2]);
              acc[j][3] = __fmaf_rn(xv, wv.w, acc[j][3]);
            }
          }
        }
      }
      const float4 bv = a.bias ? *reinterpret_cast<const float4*>(bs + co)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < WIDE_PIX; ++j) {
        const int p = pg + j * ng;
        if (p >= npix) continue;
        float4 y = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        if (a.bias) {
          y.x = __fadd_rn(y.x, bv.x);
          y.y = __fadd_rn(y.y, bv.y);
          y.z = __fadd_rn(y.z, bv.z);
          y.w = __fadd_rn(y.w, bv.w);
        }
        *reinterpret_cast<float4*>(ob + (long long)p * a.cout + co) = y;
      }
    }
  } else {
    // narrow: a thread owns NC channels of one pixel (cout > 4 runs in
    // groups of 4, the last padded with zero weight rows): each act read
    // serves NC chains; each weight read is the same for the whole warp
    const int groups = (a.cout + NC - 1) / NC;
    const bool vx = a.cin % 4 == 0 && a.cs % 4 == 0 && a.ks % 4 == 0;
    for (int u = threadIdx.x; u < npix * groups; u += blockDim.x) {
      const int p = u / groups, g = u - p * groups;
      const int r = p / a.ow;
      const float* xp = xs + (r * wp + p - r * a.ow) * a.cs;
      const float* wq = ws + g * NC * a.ks;
      float acc[NC];
#pragma unroll
      for (int q = 0; q < NC; ++q) acc[q] = 0.f;
      for (int ki = 0; ki < a.k; ++ki) {
        for (int kj = 0; kj < a.k; ++kj) {
          const float* xo = xp + (ki * wp + kj) * a.cs;
          const float* wo = wq + (ki * a.k + kj) * a.cin;
          if (vx) {
            narrow_segment<NC>(reinterpret_cast<const float4*>(xo),
                               reinterpret_cast<const float4*>(wo), a.ks / 4,
                               a.cin / 4, acc);
          } else {
            for (int c = 0; c < a.cin; ++c) {
#pragma unroll
              for (int q = 0; q < NC; ++q)
                acc[q] = __fmaf_rn(xo[c], wo[q * a.ks + c], acc[q]);
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const int co = g * NC + q;
        if (co < a.cout)
          ob[(long long)p * a.cout + co] =
              a.bias ? __fadd_rn(acc[q], bs[co]) : acc[q];
      }
    }
  }
}

template <typename T, bool WIDE, int NC>
int launch_conv(const ConvArgs& a, int blocks, int smem, const float* maxval,
                const float* zp, int exp_bits, int man_bits, int is_signed,
                int has_act, cudaStream_t s) {
  // raised per device at the first launch that needs more (an eager one:
  // a launch captured into a CUDA graph then finds it set already)
  static int smem_set[64];
  int dev = 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidValue;
    if (smem > smem_set[dev]) {
      err = cudaFuncSetAttribute(qdq_conv2d_kernel<T, WIDE, NC>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return (int)err;
      smem_set[dev] = smem;
    }
  }
  qdq_conv2d_kernel<T, WIDE, NC><<<blocks, CONV_THREADS, (size_t)smem, s>>>(
      a, maxval, zp, exp_bits, man_bits, is_signed, has_act);
  return (int)cudaGetLastError();
}

// The kernel for cout: wide, or narrow with min(cout, 4) channels a thread.
template <typename T>
int launch_for(const ConvArgs& a, int blocks, int smem, const float* mv,
               const float* zp, int eb, int mb, int sgn, int has_act,
               cudaStream_t s) {
  if (a.cout % 4 == 0)
    return launch_conv<T, true, 4>(a, blocks, smem, mv, zp, eb, mb, sgn,
                                   has_act, s);
  switch (a.cout) {
    case 1:
      return launch_conv<T, false, 1>(a, blocks, smem, mv, zp, eb, mb, sgn,
                                      has_act, s);
    case 2:
      return launch_conv<T, false, 2>(a, blocks, smem, mv, zp, eb, mb, sgn,
                                      has_act, s);
    case 3:
      return launch_conv<T, false, 3>(a, blocks, smem, mv, zp, eb, mb, sgn,
                                      has_act, s);
    default:
      return launch_conv<T, false, 4>(a, blocks, smem, mv, zp, eb, mb, sgn,
                                      has_act, s);
  }
}

}  // namespace

extern "C" int qdq_conv2d_launch(const void* x, const void* w,
                                 const void* bias, void* out, int batch, int h,
                                 int wd, int cin, int cout, int oh, int ow,
                                 int k, int ph0, int pw0, int rows, int cs,
                                 int ks, int smem, const void* maxval,
                                 const void* zp, int exp_bits, int man_bits,
                                 int is_signed, int has_act, int wdtype,
                                 void* stream) {
  if (batch <= 0 || oh <= 0 || ow <= 0) return 0;
  const bool wide = cout % 4 == 0;
  const int kdim = k * k * cin;
  ConvArgs a{(const float*)x, w, (const float*)bias, (float*)out, h, wd, cin,
             cout, oh, ow, k, ph0, pw0, rows, cs, ks};
  const long long xs =
      ((long long)(rows + k - 1) * (ow + k - 1) * cs + 3) & ~3ll;
  const int nc = wide ? 4 : (cout < 4 ? cout : 4);
  const long long ws = wide ? (long long)kdim * cout
                            : (((long long)(cout + nc - 1) / nc * nc * ks + 3)
                               & ~3ll);
  const long long need = 4 * (xs + ws + ((cout + 3) & ~3));
  if ((k != 1 && k != 3) || cin <= 0 || cout <= 0 || rows <= 0 || cs < cin
      || (!wide && ks < kdim) || ph0 < 0 || pw0 < 0 || smem < need
      || (has_act && (!maxval || !zp)))
    return (int)cudaErrorInvalidValue;
  const int blocks = batch * ((oh + rows - 1) / rows);
  cudaStream_t s = (cudaStream_t)stream;
  const float* mv = (const float*)maxval;
  const float* z = (const float*)zp;
  if (wdtype == 0)
    return launch_for<float>(a, blocks, smem, mv, z, exp_bits, man_bits,
                             is_signed, has_act, s);
  if (wdtype == 1)
    return launch_for<__nv_bfloat16>(a, blocks, smem, mv, z, exp_bits,
                                     man_bits, is_signed, has_act, s);
  return (int)cudaErrorInvalidValue;
}
