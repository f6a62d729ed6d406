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
// query's position, and > position - window when a window is given; a key
// past Sk scores -inf. p is rounded to v's type before the P.V product
// (the reference's p.astype(v_ref.dtype)) while the denominator sums p in
// f32. o is written in q's type after a 1e-30 floor on the denominator;
// the LSE variant also writes lse = m + log(l) packed as [B * H, Sq] f32
// (the TPU kernel's lane-replicated rows are a Mosaic layout, not part of
// the function). No atomics: the result is bitwise the same from run to
// run, which the remat recompute relies on.
//
// What bounds it on an H100: the tensor cores' rate. The causal work is
// 2 * B * H * S^2 * D flops, ~70 GFLOP at Llama-1B's training shape (B 4,
// H 32, Hkv 8, S 2048, D 64) against ~84 MB of q, k, v and o: 0.069 ms at
// 989 TFLOP/s bf16; ~275 GFLOP (0.278 ms) at B 1, S 8192.
//
// The bf16 kernel (the training path) is register-resident:
//  - one block per (b * h, 128-row q tile) loops over the 64-key tiles of
//    the causal/window band (the same arithmetic as _block_in_band,
//    key_band in flash_common.cuh), so out-of-band tiles are never loaded.
//    A warp owns 32 rows (two 16-row m-tiles, 4 warps) at D <= 64 and 16
//    rows (8 warps) at D 128, where two would not fit in registers;
//  - both products are mma.sync m16n8k16 bf16 -> f32 fed by ldmatrix: q's
//    A fragments are loaded once and stay in registers; each K / V fragment
//    read from shared memory feeds the warp's m-tiles; the score tile S
//    stays in registers, where it is scaled, masked (only on tiles that
//    cross the diagonal, the window edge or the ragged Sk edge) and put
//    through the online softmax, each row reduced across the four threads
//    of a quad with shuffles; p is rounded to bf16 in registers and is
//    directly the A fragment of P.V; the f32 output accumulator stays in
//    registers for the whole sweep and is rescaled there;
//  - the K / V tiles are double-buffered in shared memory with cp.async
//    16-byte copies, so tile j+1 loads while tile j is computed: one
//    barrier per key tile. Rows are padded by 16 bytes, which keeps
//    ldmatrix free of bank conflicts. A D that is not a multiple of 8
//    takes a synchronous scalar load instead;
//  - ragged Sq / Sk edges are masked here: a key past Sk scores -inf (it
//    adds nothing, even to a row whose running max is still NEG_INF), and
//    a query row past Sq is computed but never written.
// The f32 kernel runs on the FMA units (no f32 tensor-core mode keeps
// f32's precision) with 64-row tiles: each thread owns a 4 x 4 block of
// scores and a 4 x DM/16 block of the accumulator in registers.
// Heavy (late) q tiles are launched first, to shorten the causal tail.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "flash_common.cuh"

namespace {

using namespace pddl_flash;

constexpr int kBlockQ = 64;               // the f32 kernel's tiles
constexpr int kBlockK = 64;
constexpr int kPS = kBlockK + 1;          // score row stride

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
  int kt_begin, kt_end;
  key_band<kBlockQ, kBlockK>(q0, Sq, Sk, causal, window, k_offset, &kt_begin,
                             &kt_end);

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
          if (causal && !keeps(qpos, key + k_offset, window)) val = kNegInf;
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

// Shared memory of the bf16 kernel: the q tile, then two K and two V tiles
// (double buffer), every row DM + 8 bf16 wide.
template <int DM>
struct MmaLayout {
  static constexpr int LD = DM + 8;
  static constexpr size_t bytes =
      (size_t)(kMmaBlockQ + 4 * kMmaBlockK) * LD * sizeof(bf16);
};

// bf16 on the tensor cores, everything the sweep carries in registers.
template <int DM, bool kLse>
__global__ void __launch_bounds__(MmaShape<DM>::kThreads, DM <= 64 ? 2 : 1)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
                     int D, int causal, int window, int k_offset,
                     float scale) {
  constexpr int LD = MmaLayout<DM>::LD;
  constexpr int BK = kMmaBlockK;
  constexpr int MT = MmaShape<DM>::MT;     // 16-row m-tiles per warp
  constexpr int NT = MmaShape<DM>::kThreads;
  constexpr int KK = DM / 16;              // k-steps of q.k^T
  constexpr int NS = BK / 8;               // n-tiles of a score row block
  constexpr int NO = DM / 8;               // n-tiles of an output row block
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + kMmaBlockQ * LD;         // [2][BK][LD]
  bf16* sv = sk + 2 * BK * LD;             // [2][BK][LD]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int bkv = b * Hkv + h / (H / Hkv);
  const int nq = (Sq + kMmaBlockQ - 1) / kMmaBlockQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * kMmaBlockQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = warp * 16 * MT;         // this warp's first row in the tile
  const bool vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);

  const bf16* kb = k + (size_t)bkv * Sk * D;
  const bf16* vb = v + (size_t)bkv * Sk * D;

  int kt_begin, kt_end;
  key_band<kMmaBlockQ, BK>(q0, Sq, Sk, causal, window, k_offset, &kt_begin,
                           &kt_end);

  load_rows<DM, kMmaBlockQ, NT>(sq, q + (size_t)bh * Sq * D, q0, Sq, D, vec);
  if (kt_begin < kt_end) {
    load_rows<DM, BK, NT>(sk, kb, kt_begin * BK, Sk, D, vec);
    load_rows<DM, BK, NT>(sv, vb, kt_begin * BK, Sk, D, vec);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[MT][KK][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      ldmatrix_x4(qf[mt][kk], sq + a_offset<LD>(lane, wrow + 16 * mt, kk * 16));
    }

  float acc[MT][NO][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  // Per m-tile, rows g and g + 8: the running max, and this thread's part
  // of the running denominator (the quad's four parts are summed at the end).
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m_run[mt][0] = m_run[mt][1] = kNegInf;
    l_run[mt][0] = l_run[mt][1] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    if (kt > kt_begin) {
      cp_async_wait_all();
      __syncthreads();  // tile kt landed; every warp is done with tile kt-1
    }
    if (kt + 1 < kt_end) {
      load_rows<DM, BK, NT>(sk + (buf ^ 1) * BK * LD, kb, (kt + 1) * BK, Sk, D,
                            vec);
      load_rows<DM, BK, NT>(sv + (buf ^ 1) * BK * LD, vb, (kt + 1) * BK, Sk, D,
                            vec);
    }
    cp_async_commit();
    const bf16* skt = sk + buf * BK * LD;
    const bf16* svt = sv + buf * BK * LD;
    const int k0 = kt * BK;

    // s = q.k^T: 16 MT rows x 64 keys per warp, in registers; each K
    // fragment feeds the warp's MT m-tiles.
    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int p = 0; p < NS / 2; ++p) {
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        uint32_t bf[4];
        ldmatrix_x4(bf, skt + b_offset<LD>(lane, p * 16, kk * 16));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16816(s[mt][2 * p], qf[mt][kk], bf[0], bf[1]);
          mma_16816(s[mt][2 * p + 1], qf[mt][kk], bf[2], bf[3]);
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r0 = q0 + wrow + 16 * mt;
      if (scale != 1.f) {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][n][e] *= scale;
      }
      if (needs_mask<BK>(r0, k0, Sk, causal, window, k_offset)) {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + n * 8 + 2 * t + (e & 1);
            const int qpos = r0 + g + (e >> 1) * 8;
            if (key >= Sk) {
              s[mt][n][e] = -INFINITY;
            } else if (causal && !keeps(qpos, key + k_offset, window)) {
              s[mt][n][e] = kNegInf;
            }
          }
      }

      // Online softmax: row max over the quad, p = exp(s - m) in place.
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][n][0], s[mt][n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][n][2], s[mt][n][3]));
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_run[mt][i], mx[i]);
        alpha[i] = exp2_approx((m_run[mt][i] - m_new) * kLog2e);
        m_run[mt][i] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx((s[mt][n][e] - m_run[mt][e >> 1]) *
                                      kLog2e);
          s[mt][n][e] = p;
          rs[e >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l_run[mt][i] = l_run[mt][i] * alpha[i] + rs[i];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[mt][n][0] *= alpha[0];
        acc[mt][n][1] *= alpha[0];
        acc[mt][n][2] *= alpha[1];
        acc[mt][n][3] *= alpha[1];
      }
    }

    // o += p.v: p, rounded to bf16, is the A fragment as it stands; each V
    // fragment feeds the warp's MT m-tiles.
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * j][0], s[mt][2 * j][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * j][2], s[mt][2 * j][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * j + 1][0], s[mt][2 * j + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * j + 1][2], s[mt][2 * j + 1][3]);
      }
#pragma unroll
      for (int p = 0; p < DM / 16; ++p) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, svt + bt_offset<LD>(lane, j * 16, p * 16));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16816(acc[mt][2 * p], pa[mt], bf[0], bf[1]);
          mma_16816(acc[mt][2 * p + 1], pa[mt], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait_all();

  bf16* ob = o + (size_t)bh * Sq * D;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_run[mt][i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l = fmaxf(l, 1e-30f);
      const int row = q0 + wrow + 16 * mt + g + 8 * i;
      if (row >= Sq) continue;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        store_pair(ob + (size_t)row * D, n * 8 + 2 * t, D,
                   acc[mt][n][2 * i] / l, acc[mt][n][2 * i + 1] / l);
      }
      if (kLse && t == 0) {
        lse[(size_t)bh * Sq + row] = m_run[mt][i] + logf(l);
      }
    }
}

// The kernel for one padded head width DM: bf16 on the tensor cores (128-row
// tiles), f32 on the FMA units (64-row tiles).
template <int DM, bool kLse>
cudaError_t launch_dm(bool bf16_, const void* q, const void* k, const void* v,
                      void* o, void* lse, int B, int H, int Hkv, int Sq,
                      int Sk, int D, int causal, int window, int k_offset,
                      float scale, cudaStream_t s) {
  float* l = static_cast<float*>(lse);
  if (bf16_) {
    const dim3 grid(B * H, (Sq + kMmaBlockQ - 1) / kMmaBlockQ);
    return launch(flash_fwd_mma_kernel<DM, kLse>, MmaLayout<DM>::bytes,
                  grid, MmaShape<DM>::kThreads, s, static_cast<const bf16*>(q),
                  static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                  static_cast<bf16*>(o), l, H, Hkv, Sq, Sk, D, causal, window,
                  k_offset, scale);
  }
  const dim3 grid(B * H, (Sq + kBlockQ - 1) / kBlockQ);
  return launch(flash_fwd_f32_kernel<DM, kLse>,
                sizeof(float) * smem_floats<DM>(), grid, kThreads, s,
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
