// K4/K5: the FP4 (signed E2M1) KV-cache codec, and the two kernels the
// decode path runs on it.
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
//
// At decode sizes K4 and K5 sit at the launch floor (about 2 us against
// bounds of 0.001-0.07 us), and the attention around them was a score of
// small torch launches a layer. The decode path therefore runs two other
// kernels on the same codec, each one launch a layer:
//   * kv4_store encodes the new token's k AND v (2 * B * n_kv rows, one
//     warp a row, K4's arithmetic) and writes codes and scales in place at
//     the cache slot, where K4 plus four slice copies did;
//   * kv4_attend is decode attention that reads the packed cache itself:
//     K5's decode happens in shared memory, the cache is never written
//     back as bf16. One CTA per (batch, kv-head), 4 warps: the G query
//     heads of a GQA group share each staged K/V row, and each K value is
//     decoded once for all G heads (pass 1); pass 2 decodes each V value
//     once a head, G times (its chains are split by head). The packed rows of
//     the first valid_len slots (the rest are masked to -1e30, whose
//     exp(-1e30 - max) is exactly 0 in f32, so skipping them is exact) are
//     staged 128 slots a chunk (one a thread) into a two-buffer cp.async
//     ring (16, 8 or 4-byte copies, as the rows align; rows padded in
//     shared memory against bank conflicts), their scales prefetched into
//     registers a chunk ahead. Pass 1 writes the G x valid_len logits into
//     shared memory, thread t the logits of slot t; a block reduction gives
//     each head's max and sum; in pass 2 each thread owns a (head, byte
//     column) pair and sums w * v for its two output columns over every
//     slot. Each logit and each output is one f32 FMA chain in index
//     order, the order of the reference's products on the CPU and in
//     cuBLAS at these shapes (see kv4_attend_kernel). Deterministic.
//     It keeps the reference's rounding points (nn/attention.py before
//     the fusion; kernels/kv4.py:kv4_attend_plain): each decoded value is
//     K5's, rounded to the load dtype; a logit is the f32 dot of q and
//     those values times the scale, then softcap * tanhf(l / softcap)
//     where set; w = expf(l - max) / sum rounded to the load dtype; o the
//     f32 sum of w * v rounded to the output dtype. Only the softmax's
//     sums (and the last ulp of tanhf and expf) may differ from the
//     reference's.
//     No tensor cores: a CTA multiplies G (3 at smollm-135m) rows by hd x
//     valid_len decoded values, about 11 operations a byte of cache read,
//     far below the 295 at which the card stops being bound by bytes, and
//     an mma.sync tile would fill 3 of its 16 rows. Nor a split over the
//     cache: at 2048 slots the 24 CTAs of the serve shape leave most of
//     the 132 SMs idle (ROADMAP: flash-decoding split).
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

// One row's encode by one warp: codes to out[0, hd/2), the f16 scale to
// *scale.
template <typename T>
__device__ __forceinline__ void encode_row(const T* __restrict__ x,
                                           uint8_t* __restrict__ out,
                                           __half* __restrict__ scale, int hd,
                                           int lane) {
  const int half = hd / 2;
  float amax = 0.f;
  for (int j = lane; j < hd; j += 32) amax = fmaxf(amax, fabsf(msfp::to_f<T>(x[j])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = fmaxf(amax, 1e-6f);
  const float inv = __frcp_rn(s);
  for (int j = lane; j < half; j += 32) {
    const int lo = encode_one(msfp::to_f<T>(x[j]), inv);
    const int hi = encode_one(msfp::to_f<T>(x[j + half]), inv);
    out[j] = (uint8_t)(lo | (hi << 4));
  }
  if (lane == 0) *scale = __float2half_rn(s);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
kv4_encode_kernel(const T* __restrict__ t, uint8_t* __restrict__ packed,
                  __half* __restrict__ scale, int rows, int hd) {
  const int row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;           // a whole warp leaves together
  encode_row<T>(t + (size_t)row * hd, packed + (size_t)row * (hd / 2),
                scale + row, hd, threadIdx.x & 31);
}

// kv4_store: warp r < rows encodes k_new row r, warp rows + r v_new row r
// (r = b * n_kv + head), into cache cell (b, pos, head).
template <typename T>
__global__ void __launch_bounds__(THREADS)
kv4_store_kernel(const T* __restrict__ k_new, const T* __restrict__ v_new,
                 uint8_t* __restrict__ k, uint8_t* __restrict__ v,
                 __half* __restrict__ k_scale, __half* __restrict__ v_scale,
                 int rows, int n_kv, long long slots, int pos, int hd) {
  const int r = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (r >= 2 * rows) return;
  const bool is_v = r >= rows;
  const int rr = is_v ? r - rows : r;
  const int b = rr / n_kv, head = rr - b * n_kv;
  const long long cell = ((long long)b * slots + pos) * n_kv + head;
  encode_row<T>((is_v ? v_new : k_new) + (size_t)rr * hd,
                (is_v ? v : k) + cell * (hd / 2),
                (is_v ? v_scale : k_scale) + cell, hd, threadIdx.x & 31);
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

// ---- kv4_attend -----------------------------------------------------------

// CHUNK and MAX_G come from kernels/build.py (-DKV4_ATTEND_*), whose values
// kernels/kv4.py:attend_smem_bytes also sizes the dynamic shared memory
// with; the launch gets that size from there.
constexpr int ATT_THREADS = 128;   // 4 warps a CTA
constexpr int CHUNK = KV4_ATTEND_CHUNK;  // cache slots a ring stage
constexpr int MAX_G = KV4_ATTEND_MAX_G;  // query heads a kv-head
constexpr int MAX_PAIRS = MAX_G;   // pass 2's (head, byte column) pairs a thread
static_assert(CHUNK == ATT_THREADS, "pass 1 gives each thread one slot a chunk");

// A staged row's stride in shared memory: hd/2 bytes padded so that a row
// starts 16-byte aligned (8 where hd/2 is not a multiple of 16) and the
// threads' reads of consecutive rows fall in distinct banks. The same rule
// as kernels/kv4.py:attend_row_stride, which sizes the shared memory; the
// launch refuses a stride that differs. The kernel computes it rather
// than taking the argument: as an argument it cost 11% at 2048 slots on
// an H100.
__host__ __device__ __forceinline__ int row_stride(int hh) {
  return hh + (hh % 16 ? 8 : 16);
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
  }
}

// Copy the packed rows of slots [s0, s0 + n) (row s at rows + s * stride)
// into dst, rs bytes apart, in pieces of cpw bytes; one commit group.
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* rows,
                                      long long stride, int hh, int rs,
                                      int cpw, int s0, int n) {
  const int per_row = hh / cpw;
  for (int i = threadIdx.x; i < n * per_row; i += ATT_THREADS) {
    const int r = i / per_row, p = i - r * per_row;
    cp_async(dst + r * rs + p * cpw, rows + (s0 + r) * stride + p * cpw, cpw);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// K5's value of a code at f32 scale sc (f32(scale) * rcp(6)), rounded to the
// load dtype T as the decoded cache is.
template <typename T>
__device__ __forceinline__ float kv_value(int code, float sc) {
  const float v = __fmul_rn(msfp::decode_mag(code & 7, E, M), sc);
  return msfp::round_to<T>((code & 8) ? -v : v);
}

// q (B, n_kv, G, hd) T; codes (B, slots, n_kv, hd/2) u8; scales (B, slots,
// n_kv) f16; out (B, n_kv, G, hd) T. Grid B * n_kv, ATT_THREADS threads.
// Needs hd % 16 == 0, hd <= 256, G <= MAX_G, 1 <= valid <= slots. Dynamic
// shared memory, in this order: the two-chunk ring of staged rows
// (row_stride apart), q in f32, the ring's row scales, the reductions'
// scratch (8 x MAX_G), the G x valid logits.
//
// Both products sum as one FMA chain a result, in index order from zero:
// a logit over h = 0..hd-1, an output over s = 0..valid-1. That is the
// order the reference's CPU and cuBLAS products take at these shapes, and
// it matters: the attention output feeds the act snap of the next dense
// site, where a value an ulp off an E2M1 midpoint moves a code (ROADMAP
// Queue C), so another order of the same f32 sums moves whole decode steps.
template <typename T>
__global__ void __launch_bounds__(ATT_THREADS)
kv4_attend_kernel(const T* __restrict__ q, const uint8_t* __restrict__ kc,
                  const uint8_t* __restrict__ vc,
                  const __half* __restrict__ ks, const __half* __restrict__ vs,
                  T* __restrict__ out, int n_kv, int G, int hd,
                  long long slots, int valid, float scale, float softcap,
                  int cpw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int hh = hd / 2, rs = row_stride(hh);
  const int bh = blockIdx.x, b = bh / n_kv, head = bh - b * n_kv;
  uint8_t* ring = smem;                              // 2 x CHUNK x rs bytes
  float* qs = (float*)(smem + 2 * CHUNK * rs);       // G x hd
  float* scs = qs + G * hd;                          // 2 x CHUNK row scales
  float* red = scs + 2 * CHUNK;                      // 8 x MAX_G
  float* lg = red + 8 * MAX_G;                       // G x valid

  const long long stride = (long long)n_kv * hh;   // bytes slot to slot
  const long long first = (long long)b * slots * n_kv + head;
  const uint8_t* krows = kc + first * hh;
  const uint8_t* vrows = vc + first * hh;
  const __half* kscale = ks + first;                // slot s at [s * n_kv]
  const __half* vscale = vs + first;
  const float rcp6 = __frcp_rn(BASE_MAX);
  auto row_scale = [&](const __half* sc, int s) {
    return s < valid ? __fmul_rn(__half2float(sc[(long long)s * n_kv]), rcp6)
                     : 0.f;
  };
  const int n_chunks = (valid + CHUNK - 1) / CHUNK;

  stage(ring, krows, stride, hh, rs, cpw, 0, min(CHUNK, valid));
  scs[t] = row_scale(kscale, t);
  for (int i = t; i < G * hd; i += ATT_THREADS)
    qs[i] = msfp::to_f<T>(q[(long long)bh * G * hd + i]);

  // pass 1: logits, thread t the slot t of each chunk, G chains over h
  const int step = hh % 16 ? 8 : 16;   // bytes a shared-memory read
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1, s0 = c * CHUNK, n = min(CHUNK, valid - s0);
    wait_staged();   // chunk c landed; every thread is done with c - 1
    float nxt = 0.f;
    if (c + 1 < n_chunks) {
      stage(ring + (buf ^ 1) * CHUNK * rs, krows, stride, hh, rs, cpw,
            s0 + CHUNK, min(CHUNK, valid - s0 - CHUNK));
      nxt = row_scale(kscale, s0 + CHUNK + t);
    }
    if (t < n) {
      const uint8_t* row = ring + (buf * CHUNK + t) * rs;
      const float sc = scs[buf * CHUNK + t];
      float acc[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;
      for (int nib = 0; nib < 2; ++nib) {   // low nibbles: h = j, high: j + hh
        for (int j0 = 0; j0 < hh; j0 += step) {
          uint32_t w[4];
          if (step == 16) {
            const uint4 x = *(const uint4*)(row + j0);
            w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
          } else {
            const uint2 x = *(const uint2*)(row + j0);
            w[0] = x.x; w[1] = x.y; w[2] = w[3] = 0u;
          }
#pragma unroll
          for (int u = 0; u < 16; ++u) {
            if (u < step) {
              const int h = nib * hh + j0 + u;
              const float kv = kv_value<T>(
                  (w[u >> 2] >> (8 * (u & 3) + 4 * nib)) & 0xF, sc);
#pragma unroll
              for (int g = 0; g < MAX_G; ++g)
                if (g < G) acc[g] = fmaf(qs[g * hd + h], kv, acc[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          float l = __fmul_rn(acc[g], scale);
          if (softcap > 0.f) l = __fmul_rn(softcap, tanhf(__fdiv_rn(l, softcap)));
          lg[g * valid + s0 + t] = l;
        }
      }
    }
    if (c + 1 < n_chunks) scs[(buf ^ 1) * CHUNK + t] = nxt;
  }
  __syncthreads();   // every logit written, the ring free

  // V's first chunk copies while the softmax runs
  stage(ring, vrows, stride, hh, rs, cpw, 0, min(CHUNK, valid));
  const float v_sc0 = row_scale(vscale, t);

  // softmax per head: max, then expf(l - max) and its sum, each reduced by
  // warp shuffles and then over the 4 warps in a fixed order
  float mx[MAX_G], sum[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    mx[g] = __int_as_float(0xff800000);   // -inf
    if (g < G) {
      for (int s = t; s < valid; s += ATT_THREADS) mx[g] = fmaxf(mx[g], lg[g * valid + s]);
      for (int off = 16; off > 0; off >>= 1)
        mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], off));
      if (lane == 0) red[warp * MAX_G + g] = mx[g];
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    sum[g] = 0.f;
    if (g < G) {
      mx[g] = fmaxf(fmaxf(red[g], red[MAX_G + g]),
                    fmaxf(red[2 * MAX_G + g], red[3 * MAX_G + g]));
      for (int s = t; s < valid; s += ATT_THREADS) {
        const float e = expf(__fsub_rn(lg[g * valid + s], mx[g]));
        lg[g * valid + s] = e;
        sum[g] = __fadd_rn(sum[g], e);
      }
      for (int off = 16; off > 0; off >>= 1)
        sum[g] = __fadd_rn(sum[g], __shfl_xor_sync(0xffffffffu, sum[g], off));
      if (lane == 0) red[(4 + warp) * MAX_G + g] = sum[g];
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < G) {
      const float* r = red + 4 * MAX_G + g;
      const float total = __fadd_rn(__fadd_rn(__fadd_rn(r[0], r[MAX_G]),
                                              r[2 * MAX_G]), r[3 * MAX_G]);
      for (int s = t; s < valid; s += ATT_THREADS)
        lg[g * valid + s] = msfp::round_to<T>(__fdiv_rn(lg[g * valid + s], total));
    }
  }
  scs[t] = v_sc0;

  // pass 2: o = sum_s w * v. Pair p = t + k * ATT_THREADS (k < MAX_PAIRS)
  // is head p / hh and byte column p % hh, whose two outputs (columns j
  // and j + hh) each sum over every slot in order.
  float alo[MAX_PAIRS], ahi[MAX_PAIRS];
#pragma unroll
  for (int k = 0; k < MAX_PAIRS; ++k) alo[k] = ahi[k] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1, s0 = c * CHUNK, n = min(CHUNK, valid - s0);
    wait_staged();   // also orders the softmax's writes before the reads
    float nxt = 0.f;
    if (c + 1 < n_chunks) {
      stage(ring + (buf ^ 1) * CHUNK * rs, vrows, stride, hh, rs, cpw,
            s0 + CHUNK, min(CHUNK, valid - s0 - CHUNK));
      nxt = row_scale(vscale, s0 + CHUNK + t);
    }
#pragma unroll
    for (int k = 0; k < MAX_PAIRS; ++k) {
      const int p = t + k * ATT_THREADS;
      if (p < G * hh) {
        const int g = p / hh, j = p - g * hh;
        const uint8_t* col = ring + buf * CHUNK * rs + j;
        const float* w = lg + g * valid + s0;
        const float* sc = scs + buf * CHUNK;
#pragma unroll 8   // the slots' reads and decodes overlap; the sums stay in order
        for (int i = 0; i < n; ++i) {
          const int byte = col[i * rs];
          alo[k] = fmaf(w[i], kv_value<T>(byte & 0xF, sc[i]), alo[k]);
          ahi[k] = fmaf(w[i], kv_value<T>(byte >> 4, sc[i]), ahi[k]);
        }
      }
    }
    if (c + 1 < n_chunks) scs[(buf ^ 1) * CHUNK + t] = nxt;
  }
#pragma unroll
  for (int k = 0; k < MAX_PAIRS; ++k) {
    const int p = t + k * ATT_THREADS;
    if (p < G * hh) {
      const int g = p / hh, j = p - g * hh;
      T* o = out + ((long long)bh * G + g) * hd;
      o[j] = msfp::from_f<T>(alo[k]);
      o[j + hh] = msfp::from_f<T>(ahi[k]);
    }
  }
}

template <typename T>
int launch_attend(const void* q, const void* kc, const void* vc,
                  const void* ks, const void* vs, void* out, int batch,
                  int n_kv, int g, int hd, long long slots, int valid,
                  float scale, float softcap, int cpw, int smem,
                  cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kv4_attend_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  kv4_attend_kernel<T><<<batch * n_kv, ATT_THREADS, (size_t)smem, s>>>(
      (const T*)q, (const uint8_t*)kc, (const uint8_t*)vc,
      (const __half*)ks, (const __half*)vs, (T*)out, n_kv, g, hd, slots,
      valid, scale, softcap, cpw);
  return (int)cudaGetLastError();
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

extern "C" int kv4_store_launch(const void* k_new, const void* v_new,
                                void* k, void* v, void* k_scale,
                                void* v_scale, int batch, int n_kv,
                                long long slots, int pos, int hd, int dtype,
                                void* stream) {
  const int rows = batch * n_kv;
  if (rows <= 0) return 0;
  if (hd <= 0 || hd % 2 || pos < 0 || pos >= slots)
    return (int)cudaErrorInvalidValue;
  const int per_block = THREADS / 32;
  const int blocks = (2 * rows + per_block - 1) / per_block;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    kv4_store_kernel<float><<<blocks, THREADS, 0, s>>>(
        (const float*)k_new, (const float*)v_new, (uint8_t*)k, (uint8_t*)v,
        (__half*)k_scale, (__half*)v_scale, rows, n_kv, slots, pos, hd);
  } else if (dtype == 1) {
    kv4_store_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new,
        (uint8_t*)k, (uint8_t*)v, (__half*)k_scale, (__half*)v_scale, rows,
        n_kv, slots, pos, hd);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int kv4_attend_launch(const void* q, const void* k, const void* v,
                                 const void* k_scale, const void* v_scale,
                                 void* out, int batch, int n_kv, int g, int hd,
                                 long long slots, int valid, float scale,
                                 float softcap, int cpw, int rs, int smem,
                                 int dtype, void* stream) {
  if (batch * n_kv <= 0) return 0;
  const int hh = hd / 2;
  if (hd % 16 || hd <= 0 || hd > 256 || g < 1 || g > MAX_G || valid < 1
      || valid > slots || (cpw != 4 && cpw != 8 && cpw != 16) || hh % cpw
      || rs != row_stride(hh) || smem <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_attend<float>(q, k, v, k_scale, v_scale, out, batch, n_kv,
                                g, hd, slots, valid, scale, softcap, cpw,
                                smem, s);
  if (dtype == 1)
    return launch_attend<__nv_bfloat16>(q, k, v, k_scale, v_scale, out, batch,
                                        n_kv, g, hd, slots, valid, scale,
                                        softcap, cpw, smem, s);
  return (int)cudaErrorInvalidValue;
}
