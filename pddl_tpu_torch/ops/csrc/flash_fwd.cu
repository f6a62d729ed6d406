// Flash-attention forward for Hopper (sm_90a): causal or full, optionally
// sliding-window, grouped-query softmax attention with an online softmax.
//
// Replaces the Pallas kernels pddl_tpu/ops/attention.py:_flash_kernel and
// _flash_kernel_nolse (launched by _flash_forward_call). It computes the
// same function: q [B, H, Sq, D]; k, v [B, Hkv, Sk, D] (f32 or bf16, all
// one type); query head h reads kv head h / (H / Hkv). Scores are
// scale * q.k in f32 (the multiply is skipped when the caller folded a
// power-of-two scale into q and passes 1); a masked score is NEG_INF =
// -1e30, as in the reference: key position kj + k_offset must be <= the
// query's position, and > position - window when a window is given. p is
// rounded to v's type before the P.V product (the reference's
// p.astype(v_ref.dtype)) while the denominator sums p in f32. o is written
// in q's type after a 1e-30 floor on the denominator; the LSE variant also
// writes lse = m + log(l) packed as [B * H, Sq] f32 (the TPU kernel's
// lane-replicated rows are a Mosaic layout, not part of the function).
//
// What bounds it on an H100: at Llama-1B's training shape (B 4, H 32,
// Hkv 8, S 2048, D 64) the causal work is 2 * B * H * S^2 * D flops, ~70
// GFLOP, against ~84 MB of q/k/v/o, so the tensor cores' rate bounds it
// (~0.07 ms at 989 TFLOP/s bf16). The design is the simple one:
//  - one block of 256 threads (8 warps) per (b * h, 64-row q tile); a loop
//    over the 64-key tiles in the causal/window band takes the place of the
//    TPU's sequential k grid axis, its bounds from the same arithmetic as
//    _block_in_band, so out-of-band tiles are never loaded;
//  - the q tile and each K / V tile are staged in shared memory,
//    zero-padded to DM = 16/32/64/128 columns;
//  - bf16 (the training path): both products run on the tensor cores as
//    WMMA 16x16x16 bf16 fragments with f32 accumulation (bf16 products are
//    exact in f32, as on the TPU's MXU). The score tile goes through shared
//    memory for the masked online softmax (four threads per row), p is
//    stored as bf16 (the rounding point above), and the f32 output
//    accumulator lives in shared memory so each row can be rescaled by
//    exp(m_old - m_new) before the P.V fragments add to it;
//  - f32: the products run on the f32 FMA units (no f32 tensor-core mode
//    keeps f32's precision); each thread owns a 4 x 4 block of scores and a
//    4 x DM/16 block of the accumulator in registers;
//  - ragged Sq / Sk edges are masked here: a key past Sk scores -inf (it
//    adds nothing, even to a row whose running max is still NEG_INF), and
//    a query row past Sq is computed but never written.
// Heavy (late) q tiles are launched first, to shorten the causal tail.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include <cstdint>

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kPS = kBlockK + 1;          // score row stride
constexpr size_t kMaxSmem = 232448;       // an H100 block's dynamic shared memory

__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

template <int DM>
constexpr size_t smem_floats() {
  return (size_t)kBlockQ * DM + (size_t)kBlockK * (DM + 1) +
         (size_t)kBlockK * DM + (size_t)kBlockQ * kPS + 3 * (size_t)kBlockQ;
}

// f32: every product on the FMA units.
template <int DM, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
                     int D, int causal, int window, int k_offset,
                     float scale) {
  constexpr int KS = DM + 1;
  constexpr int NJ = DM / 16;
  extern __shared__ float smem[];
  float* sq = smem;                       // [64][DM]
  float* sk = sq + kBlockQ * DM;          // [64][DM + 1]
  float* sv = sk + kBlockK * KS;          // [64][DM]
  float* sp = sv + kBlockK * DM;          // [64][65] scores, then p
  float* sm = sp + kBlockQ * kPS;         // [64] running max
  float* sl = sm + kBlockQ;               // [64] running denominator
  float* salpha = sl + kBlockQ;           // [64] this tile's rescale

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int bkv = b * Hkv + h / (H / Hkv);
  const int nq = (Sq + kBlockQ - 1) / kBlockQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * kBlockQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;                // rows ty*4 .. ty*4+3
  const int tx = tid & 15;                // cols tx + 16*j

  const float* qb = q + (size_t)bh * Sq * D;
  const float* kb = k + (size_t)bkv * Sk * D;
  const float* vb = v + (size_t)bkv * Sk * D;

  for (int i = tid; i < kBlockQ * DM; i += kThreads) {
    const int r = i / DM;
    const int d = i - r * DM;
    const int row = q0 + r;
    sq[i] = (row < Sq && d < D) ? qb[(size_t)row * D + d] : 0.f;
  }
  if (tid < kBlockQ) {
    sm[tid] = kNegInf;
    sl[tid] = 0.f;
  }

  // The k tiles in the band of this q tile (_block_in_band's arithmetic).
  int kt_begin = 0;
  int kt_end = (Sk + kBlockK - 1) / kBlockK;
  if (causal) {
    const int q_last = min(q0 + kBlockQ - 1, Sq - 1);
    kt_end = min(kt_end, max(0, floor_div(q_last - k_offset, kBlockK) + 1));
    if (window > 0) {
      kt_begin = max(0, floor_div(q0 - window + 1 - k_offset, kBlockK));
    }
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    for (int i = tid; i < kBlockK * DM; i += kThreads) {
      const int r = i / DM;
      const int d = i - r * DM;
      const int key = k0 + r;
      const bool ok = key < Sk && d < D;
      sk[r * KS + d] = ok ? kb[(size_t)key * D + d] : 0.f;
      sv[i] = ok ? vb[(size_t)key * D + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DM; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sq[(ty * 4 + i) * DM + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sk[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int key = k0 + c;
        float val = -INFINITY;
        if (key < Sk) {
          val = scale != 1.f ? scale * s[i][j] : s[i][j];
          if (causal) {
            const int kpos = key + k_offset;
            bool keep = qpos >= kpos;
            if (window > 0) keep = keep && kpos > qpos - window;
            if (!keep) val = kNegInf;
          }
        }
        sp[r * kPS + c] = val;
      }
    }
    __syncthreads();

    // Online-softmax update: four threads per row, 16 scores each.
    {
      const int r = tid >> 2;
      const int part = tid & 3;
      float* pr = sp + r * kPS + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, pr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = sm[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(pr[c] - m_new);
        sum += p;
        pr[c] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();  // the row's four threads have read m_prev
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        sl[r] = sl[r] * alpha + sum;
        sm[r] = m_new;
        salpha[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = salpha[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= a;
    }
#pragma unroll 8
    for (int c = 0; c < kBlockK; ++c) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sp[(ty * 4 + i) * kPS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = sv[c * DM + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* ob = o + (size_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int row = q0 + r;
    if (row >= Sq) continue;
    const float l = fmaxf(sl[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) ob[(size_t)row * D + d] = acc[i][j] / l;
    }
  }
  if (kLse && tid < kBlockQ && q0 + tid < Sq) {
    lse[(size_t)bh * Sq + q0 + tid] = sm[tid] + logf(fmaxf(sl[tid], 1e-30f));
  }
}

// Stage rows [row0, row0 + 64) of a [rows, D] bf16 array into a [64][ld]
// shared tile, zero-filled past `rows` and past D. When rows are exactly DM
// wide and the array is 16-byte aligned, each row goes as 16-byte vectors
// (8 values per load and store); otherwise one value at a time.
template <int DM>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          int row0, int rows, int D) {
  if (D == DM && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    constexpr int kVecs = DM / 8;
    for (int i = threadIdx.x; i < kBlockQ * kVecs; i += kThreads) {
      const int r = i / kVecs;
      const int c = (i - r * kVecs) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < rows) {
        val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * DM + c);
      }
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
    return;
  }
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < kBlockQ * DM; i += kThreads) {
    const int r = i / DM;
    const int d = i - r * DM;
    const int row = row0 + r;
    dst[r * ld + d] = (row < rows && d < D) ? src[(size_t)row * D + d] : zero;
  }
}

// Shared-memory layout of the bf16 tensor-core kernel (row strides padded
// as WMMA's loads require: a multiple of 8 bf16 / 4 floats, 32-byte
// aligned tiles).
template <int DM>
struct WmmaLayout {
  static constexpr int LD = DM + 8;        // q, k, v tiles (bf16)
  static constexpr int LS = kBlockK + 4;   // scores (f32)
  static constexpr int LP = kBlockK + 8;   // p (bf16)
  static constexpr int LO = DM + 4;        // output accumulator (f32)
  static constexpr size_t bytes =
      3 * kBlockQ * LD * sizeof(bf16) + kBlockQ * LS * sizeof(float) +
      kBlockQ * LP * sizeof(bf16) + kBlockQ * LO * sizeof(float) +
      2 * kBlockQ * sizeof(float);
};

template <int DM, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
                      int D, int causal, int window, int k_offset,
                      float scale) {
  using L = WmmaLayout<DM>;
  constexpr int NC = DM / 16;              // 16-column blocks of a row
  constexpr int NFO = 4 * NC;              // output fragments per tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + kBlockQ * L::LD;
  bf16* sv = sk + kBlockK * L::LD;
  float* ss = reinterpret_cast<float*>(sv + kBlockK * L::LD);
  bf16* sp = reinterpret_cast<bf16*>(ss + kBlockQ * L::LS);
  float* so = reinterpret_cast<float*>(sp + kBlockQ * L::LP);
  float* sm = so + kBlockQ * L::LO;
  float* sl = sm + kBlockQ;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int bkv = b * Hkv + h / (H / Hkv);
  const int nq = (Sq + kBlockQ - 1) / kBlockQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  const bf16* kb = k + (size_t)bkv * Sk * D;
  const bf16* vb = v + (size_t)bkv * Sk * D;

  load_tile<DM>(sq, L::LD, q + (size_t)bh * Sq * D, q0, Sq, D);
  for (int i = tid; i < kBlockQ * DM; i += kThreads) {
    so[(i / DM) * L::LO + i % DM] = 0.f;
  }
  if (tid < kBlockQ) {
    sm[tid] = kNegInf;
    sl[tid] = 0.f;
  }

  int kt_begin = 0;
  int kt_end = (Sk + kBlockK - 1) / kBlockK;
  if (causal) {
    const int q_last = min(q0 + kBlockQ - 1, Sq - 1);
    kt_end = min(kt_end, max(0, floor_div(q_last - k_offset, kBlockK) + 1));
    if (window > 0) {
      kt_begin = max(0, floor_div(q0 - window + 1 - k_offset, kBlockK));
    }
  }
  __syncthreads();

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    load_tile<DM>(sk, L::LD, kb, k0, Sk, D);
    load_tile<DM>(sv, L::LD, vb, k0, Sk, D);
    __syncthreads();

    // s = q.k^T: 16 fragments of 16 x 16, two per warp.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int f = warp + 8 * i;
      const int rb = f >> 2;
      const int cb = f & 3;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < NC; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, sq + rb * 16 * L::LD + kk * 16, L::LD);
        wmma::load_matrix_sync(bt, sk + cb * 16 * L::LD + kk * 16, L::LD);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(ss + rb * 16 * L::LS + cb * 16, acc, L::LS,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // Masked online softmax, four threads per row; each also rescales its
    // quarter of the row's output accumulator.
    {
      const int r = tid >> 2;
      const int part = tid & 3;
      const int qpos = q0 + r;
      float val[16];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int col = part * 16 + c;
        const int key = k0 + col;
        float x = -INFINITY;
        if (key < Sk) {
          x = ss[r * L::LS + col];
          if (scale != 1.f) x *= scale;
          if (causal) {
            const int kpos = key + k_offset;
            bool keep = qpos >= kpos;
            if (window > 0) keep = keep && kpos > qpos - window;
            if (!keep) x = kNegInf;
          }
        }
        val[c] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = sm[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(val[c] - m_new);
        sum += p;
        sp[r * L::LP + part * 16 + c] = __float2bfloat16(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m_prev - m_new);
#pragma unroll
      for (int d = part * (DM / 4); d < (part + 1) * (DM / 4); ++d) {
        so[r * L::LO + d] *= alpha;
      }
      __syncwarp();  // the row's four threads have read m_prev
      if (part == 0) {
        sl[r] = sl[r] * alpha + sum;
        sm[r] = m_new;
      }
    }
    __syncthreads();

    // o += p.v, the accumulator fragments round-tripping through smem.
    for (int f = warp; f < NFO; f += 8) {
      const int rb = f / NC;
      const int cb = f - rb * NC;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, so + rb * 16 * L::LO + cb * 16, L::LO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, sp + rb * 16 * L::LP + kk * 16, L::LP);
        wmma::load_matrix_sync(bv, sv + kk * 16 * L::LD + cb * 16, L::LD);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(so + rb * 16 * L::LO + cb * 16, acc, L::LO,
                              wmma::mem_row_major);
    }
    __syncthreads();
  }

  bf16* ob = o + (size_t)bh * Sq * D;
  for (int i = tid; i < kBlockQ * DM; i += kThreads) {
    const int r = i / DM;
    const int d = i - r * DM;
    const int row = q0 + r;
    if (row < Sq && d < D) {
      ob[(size_t)row * D + d] =
          __float2bfloat16(so[r * L::LO + d] / fmaxf(sl[r], 1e-30f));
    }
  }
  if (kLse && tid < kBlockQ && q0 + tid < Sq) {
    lse[(size_t)bh * Sq + q0 + tid] = sm[tid] + logf(fmaxf(sl[tid], 1e-30f));
  }
}

// Launch a kernel of 256 threads with `smem` bytes of dynamic shared memory
// (raising the per-block limit above 48 KiB where it needs more).
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, cudaStream_t stream,
                   Args... args) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The kernel for one padded head width DM: bf16 on the tensor cores, f32 on
// the FMA units.
template <int DM, bool kLse>
cudaError_t launch_dm(bool bf16_, const void* q, const void* k, const void* v,
                      void* o, void* lse, int B, int H, int Hkv, int Sq,
                      int Sk, int D, int causal, int window, int k_offset,
                      float scale, cudaStream_t s) {
  const dim3 grid(B * H, (Sq + kBlockQ - 1) / kBlockQ);
  float* l = static_cast<float*>(lse);
  if (bf16_) {
    return launch(flash_fwd_wmma_kernel<DM, kLse>, WmmaLayout<DM>::bytes,
                  grid, s, static_cast<const bf16*>(q),
                  static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                  static_cast<bf16*>(o), l, H, Hkv, Sq, Sk, D, causal, window,
                  k_offset, scale);
  }
  return launch(flash_fwd_f32_kernel<DM, kLse>,
                sizeof(float) * smem_floats<DM>(), grid, s,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(o), l, H,
                Hkv, Sq, Sk, D, causal, window, k_offset, scale);
}

template <bool kLse>
cudaError_t launch_lse(bool bf16_, const void* q, const void* k,
                       const void* v, void* o, void* lse, int B, int H,
                       int Hkv, int Sq, int Sk, int D, int causal, int window,
                       int k_offset, float scale, cudaStream_t s) {
  if (D <= 16)
    return launch_dm<16, kLse>(bf16_, q, k, v, o, lse, B, H, Hkv, Sq, Sk, D,
                               causal, window, k_offset, scale, s);
  if (D <= 32)
    return launch_dm<32, kLse>(bf16_, q, k, v, o, lse, B, H, Hkv, Sq, Sk, D,
                               causal, window, k_offset, scale, s);
  if (D <= 64)
    return launch_dm<64, kLse>(bf16_, q, k, v, o, lse, B, H, Hkv, Sq, Sk, D,
                               causal, window, k_offset, scale, s);
  return launch_dm<128, kLse>(bf16_, q, k, v, o, lse, B, H, Hkv, Sq, Sk, D,
                              causal, window, k_offset, scale, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. lse == NULL launches the variant that
// writes no LSE. causal: 0 or 1; window <= 0 means no window. D <= 128.
// Returns 0 on a launched kernel, else the cudaError_t of the refusal.
int pddl_flash_fwd(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Hkv, int Sq, int Sk, int D,
                   int causal, int window, int k_offset, float scale,
                   int dtype, void* stream) {
  if (B < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Sk < 1 || D < 1 ||
      D > 128 || (long long)(Sq + kBlockQ - 1) / kBlockQ > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lse != nullptr) {
    return (int)launch_lse<true>(dtype == 1, q, k, v, o, lse, B, H, Hkv, Sq,
                                 Sk, D, causal, window, k_offset, scale, s);
  }
  return (int)launch_lse<false>(dtype == 1, q, k, v, o, lse, B, H, Hkv, Sq,
                                Sk, D, causal, window, k_offset, scale, s);
}

const char* pddl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
