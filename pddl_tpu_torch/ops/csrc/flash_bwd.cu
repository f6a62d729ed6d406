// Fused single-sweep flash-attention backward for Hopper (sm_90a): dq, dk
// and dv in one pass over the (k tile, q tile) pairs of the causal band.
//
// Replaces the Pallas kernel pddl_tpu/ops/attention.py:_flash_bwd_fused_kernel
// (launched by _flash_bwd_impl when rep * Sq * D * 4 <= 6 MiB). It computes
// the same function. Inputs as the forward (q, do [B, H, Sq, D]; k, v
// [B, Hkv, Sk, D]; one type, f32 or bf16) plus the forward's lse and the
// row term di = rowsum(do * o) - dlse, both [B * H, Sq] f32, built by the
// caller. For every pair it recomputes
//   s = scale * q.k (masked to NEG_INF as in the forward), p = exp(s - lse),
//   dp = do.v, ds = p * (dp - di),
// and adds dv += p^T.do, dk += scale * ds^T.q, dq += scale * ds.k, with the
// reference's rounding points: p is rounded to do's type before the dv
// product, ds to q's and k's type before the dk and dq products, and every
// product accumulates in f32. dk and dv are summed over the rep = H / Hkv
// query heads of their kv head.
//
// What bounds it on an H100: 5 products per tile pair, 5 * B * H * S^2 * D
// causal flops (~172 GFLOP at Llama-1B's training shape), so the tensor
// cores' rate (~0.17 ms at 989 TFLOP/s bf16). The design:
//  - one block of 256 threads (8 warps) per (b * hkv, 64-key tile) holds
//    its K and V tiles in shared memory and its dk / dv accumulators for
//    the whole sweep; a loop over the group's query heads and the q tiles
//    in the band (the forward's band arithmetic seen from the keys) takes
//    the place of the TPU's sequential inner grid axis;
//  - bf16 (the training path): the five products run on the tensor cores
//    as WMMA 16x16x16 bf16 fragments with f32 accumulation; s and dp go
//    through shared memory for the elementwise p / ds pass, which stores p
//    and ds as bf16 (the rounding points above) for the dv, dk and dq
//    products; dk and dv stay in accumulator fragments for the sweep;
//  - f32: the products run on the f32 FMA units (rows of K / V padded by
//    one against bank conflicts), dk / dv in registers;
//  - dq: the TPU kernel keeps a whole-sequence dq scratch in VMEM and relies
//    on the grid running in order. Hopper blocks run concurrently, so each
//    block adds its [64, D] dq contribution for a q tile with f32 atomicAdd
//    into a [B * H, Sq, D] f32 buffer the caller zeroes and casts. The order
//    of those additions changes from run to run, so dq is NOT bitwise
//    reproducible: two runs agree to f32 rounding, not exactly;
//  - ragged Sq / Sk edges are masked here (p = ds = 0 outside the arrays).
// The heaviest key tiles (the first ones under a causal mask) launch first.

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
constexpr int kPS = kBlockK + 1;
constexpr size_t kMaxSmem = 232448;

__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

template <int DM>
constexpr size_t smem_floats() {
  return 2 * (size_t)kBlockQ * DM + 2 * (size_t)kBlockK * (DM + 1) +
         2 * (size_t)kBlockQ * kPS + 2 * (size_t)kBlockQ;
}

// f32: every product on the FMA units.
template <int DM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, float* __restrict__ dq,
                     float* __restrict__ dk, float* __restrict__ dv, int H,
                     int Hkv, int Sq, int Sk, int D, int causal, int window,
                     int k_offset, float scale) {
  constexpr int KS = DM + 1;
  constexpr int NJ = DM / 16;
  extern __shared__ float smem[];
  float* sq = smem;                       // [64][DM]
  float* sdo = sq + kBlockQ * DM;         // [64][DM]
  float* sk = sdo + kBlockQ * DM;         // [64][DM + 1]
  float* sv = sk + kBlockK * KS;          // [64][DM + 1]
  float* sp = sv + kBlockK * KS;          // [64 q][65] p, rounded
  float* sds = sp + kBlockQ * kPS;        // [64 q][65] ds, rounded
  float* slse = sds + kBlockQ * kPS;      // [64]
  float* sdi = slse + kBlockQ;            // [64]

  const int bkv = blockIdx.x;
  const int b = bkv / Hkv;
  const int g = bkv - b * Hkv;
  const int rep = H / Hkv;
  const int k0 = blockIdx.y * kBlockK;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  const float* kb = k + (size_t)bkv * Sk * D;
  const float* vb = v + (size_t)bkv * Sk * D;
  for (int i = tid; i < kBlockK * DM; i += kThreads) {
    const int r = i / DM;
    const int d = i - r * DM;
    const int key = k0 + r;
    const bool ok = key < Sk && d < D;
    sk[r * KS + d] = ok ? kb[(size_t)key * D + d] : 0.f;
    sv[r * KS + d] = ok ? vb[(size_t)key * D + d] : 0.f;
  }

  // The q tiles whose rows see a key of this tile.
  const int nq = (Sq + kBlockQ - 1) / kBlockQ;
  int qt_begin = 0;
  int qt_end = nq;
  if (causal) {
    qt_begin = max(0, floor_div(k0 + k_offset, kBlockQ));
    if (window > 0) {
      const int k_last = min(k0 + kBlockK - 1, Sk - 1) + k_offset;
      qt_end = min(nq, max(0, floor_div(k_last + window - 1, kBlockQ) + 1));
    }
  }

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int r = 0; r < rep; ++r) {
    const int bh = b * H + g * rep + r;
    const float* qb = q + (size_t)bh * Sq * D;
    const float* dob = dout + (size_t)bh * Sq * D;
    float* dqb = dq + (size_t)bh * Sq * D;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kBlockQ;
      __syncthreads();  // the previous pair is done with sq / sdo / sp / sds
      for (int i = tid; i < kBlockQ * DM; i += kThreads) {
        const int rr = i / DM;
        const int d = i - rr * DM;
        const int row = q0 + rr;
        const bool ok = row < Sq && d < D;
        sq[i] = ok ? qb[(size_t)row * D + d] : 0.f;
        sdo[i] = ok ? dob[(size_t)row * D + d] : 0.f;
      }
      if (tid < kBlockQ) {
        const int row = q0 + tid;
        slse[tid] = row < Sq ? lse[(size_t)bh * Sq + row] : 0.f;
        sdi[tid] = row < Sq ? di[(size_t)bh * Sq + row] : 0.f;
      }
      __syncthreads();

      // s = q.k and dp = do.v for rows ty*4+i, keys tx+16*j.
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DM; ++d) {
        float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = sq[(ty * 4 + i) * DM + d];
          ov[i] = sdo[(ty * 4 + i) * DM + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kv[j] = sk[(tx + 16 * j) * KS + d];
          vv[j] = sv[(tx + 16 * j) * KS + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = ty * 4 + i;
        const int qpos = q0 + rr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const int key = k0 + c;
          float p = 0.f, ds = 0.f;
          if (qpos < Sq && key < Sk) {
            float val = scale != 1.f ? scale * s[i][j] : s[i][j];
            if (causal) {
              const int kpos = key + k_offset;
              bool keep = qpos >= kpos;
              if (window > 0) keep = keep && kpos > qpos - window;
              if (!keep) val = kNegInf;
            }
            p = expf(val - slse[rr]);
            ds = p * (dp[i][j] - sdi[rr]);
          }
          sp[rr * kPS + c] = p;
          sds[rr * kPS + c] = ds;
        }
      }
      __syncthreads();

      // dv += p^T.do and dk += ds^T.q for keys ty*4+i, columns tx+16*j.
#pragma unroll 4
      for (int qq = 0; qq < kBlockQ; ++qq) {
        float pv[4], dsv[4], ov[NJ], qv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = sp[qq * kPS + ty * 4 + i];
          dsv[i] = sds[qq * kPS + ty * 4 + i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          ov[j] = sdo[qq * DM + tx + 16 * j];
          qv[j] = sq[qq * DM + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dv_acc[i][j] = fmaf(pv[i], ov[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
          }
      }

      // This pair's dq rows: ds.k for rows ty*4+i, columns tx+16*j.
      float dq_acc[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dq_acc[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < kBlockK; ++c) {
        float dsv[4], kv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) dsv[i] = sds[(ty * 4 + i) * kPS + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) kv[j] = sk[c * KS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            dq_acc[i][j] = fmaf(dsv[i], kv[j], dq_acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        if (row >= Sq) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = tx + 16 * j;
          if (d < D) {
            const float x = scale != 1.f ? scale * dq_acc[i][j] : dq_acc[i][j];
            atomicAdd(dqb + (size_t)row * D + d, x);
          }
        }
      }
    }
  }

  float* dkb = dk + (size_t)bkv * Sk * D;
  float* dvb = dv + (size_t)bkv * Sk * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= Sk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        const float x = scale != 1.f ? scale * dk_acc[i][j] : dk_acc[i][j];
        dkb[(size_t)key * D + d] = x;
        dvb[(size_t)key * D + d] = dv_acc[i][j];
      }
    }
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
  static constexpr int LD = DM + 8;        // q, do, k, v tiles (bf16)
  static constexpr int LS = kBlockK + 4;   // s, dp (f32)
  static constexpr int LP = kBlockK + 8;   // p, ds (bf16)
  static constexpr int LQ = DM + 4;        // dq staging (f32)
  static constexpr size_t bytes =
      4 * kBlockQ * LD * sizeof(bf16) + 2 * kBlockQ * LS * sizeof(float) +
      2 * kBlockQ * LP * sizeof(bf16) + kBlockQ * LQ * sizeof(float) +
      2 * kBlockQ * sizeof(float);
  static_assert(kBlockK * LQ <= 2 * kBlockQ * LS,
                "dv staging reuses the s / dp tiles");
};

template <int DM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_wmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ di, float* __restrict__ dq,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                      int Hkv, int Sq, int Sk, int D, int causal, int window,
                      int k_offset, float scale) {
  using L = WmmaLayout<DM>;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                               wmma::row_major>;
  using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                                wmma::col_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                               wmma::row_major>;
  using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                                wmma::col_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  constexpr int NC = DM / 16;              // 16-column blocks of a row
  constexpr int NF = 4 * NC;               // [64, DM] fragments
  constexpr int FPW = NF >= 8 ? NF / 8 : 1;  // of them per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + kBlockQ * L::LD;
  bf16* sk = sdo + kBlockQ * L::LD;
  bf16* sv = sk + kBlockK * L::LD;
  float* ss = reinterpret_cast<float*>(sv + kBlockK * L::LD);
  float* sdp = ss + kBlockQ * L::LS;
  bf16* sp = reinterpret_cast<bf16*>(sdp + kBlockQ * L::LS);
  bf16* sds = sp + kBlockQ * L::LP;
  float* sdq = reinterpret_cast<float*>(sds + kBlockQ * L::LP);
  float* slse = sdq + kBlockQ * L::LQ;
  float* sdi = slse + kBlockQ;

  const int bkv = blockIdx.x;
  const int b = bkv / Hkv;
  const int g = bkv - b * Hkv;
  const int rep = H / Hkv;
  const int k0 = blockIdx.y * kBlockK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  load_tile<DM>(sk, L::LD, k + (size_t)bkv * Sk * D, k0, Sk, D);
  load_tile<DM>(sv, L::LD, v + (size_t)bkv * Sk * D, k0, Sk, D);

  const int nq = (Sq + kBlockQ - 1) / kBlockQ;
  int qt_begin = 0;
  int qt_end = nq;
  if (causal) {
    qt_begin = max(0, floor_div(k0 + k_offset, kBlockQ));
    if (window > 0) {
      const int k_last = min(k0 + kBlockK - 1, Sk - 1) + k_offset;
      qt_end = min(nq, max(0, floor_div(k_last + window - 1, kBlockQ) + 1));
    }
  }

  FragC dk_acc[FPW], dv_acc[FPW];
#pragma unroll
  for (int i = 0; i < FPW; ++i) {
    wmma::fill_fragment(dk_acc[i], 0.f);
    wmma::fill_fragment(dv_acc[i], 0.f);
  }

  for (int r = 0; r < rep; ++r) {
    const int bh = b * H + g * rep + r;
    const bf16* qb = q + (size_t)bh * Sq * D;
    const bf16* dob = dout + (size_t)bh * Sq * D;
    float* dqb = dq + (size_t)bh * Sq * D;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kBlockQ;
      __syncthreads();  // the previous pair is done with every tile
      load_tile<DM>(sq, L::LD, qb, q0, Sq, D);
      load_tile<DM>(sdo, L::LD, dob, q0, Sq, D);
      if (tid < kBlockQ) {
        const int row = q0 + tid;
        slse[tid] = row < Sq ? lse[(size_t)bh * Sq + row] : 0.f;
        sdi[tid] = row < Sq ? di[(size_t)bh * Sq + row] : 0.f;
      }
      __syncthreads();

      // s = q.k^T and dp = do.v^T: 16 fragments each, two per warp.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int f = warp + 8 * i;
        const int rb = f >> 2;
        const int cb = f & 3;
        FragC acc_s, acc_dp;
        wmma::fill_fragment(acc_s, 0.f);
        wmma::fill_fragment(acc_dp, 0.f);
#pragma unroll
        for (int kk = 0; kk < NC; ++kk) {
          FragA a;
          FragBT bt;
          wmma::load_matrix_sync(a, sq + rb * 16 * L::LD + kk * 16, L::LD);
          wmma::load_matrix_sync(bt, sk + cb * 16 * L::LD + kk * 16, L::LD);
          wmma::mma_sync(acc_s, a, bt, acc_s);
          wmma::load_matrix_sync(a, sdo + rb * 16 * L::LD + kk * 16, L::LD);
          wmma::load_matrix_sync(bt, sv + cb * 16 * L::LD + kk * 16, L::LD);
          wmma::mma_sync(acc_dp, a, bt, acc_dp);
        }
        wmma::store_matrix_sync(ss + rb * 16 * L::LS + cb * 16, acc_s, L::LS,
                                wmma::mem_row_major);
        wmma::store_matrix_sync(sdp + rb * 16 * L::LS + cb * 16, acc_dp,
                                L::LS, wmma::mem_row_major);
      }
      __syncthreads();

      // p = exp(s - lse) and ds = p * (dp - di), stored as bf16.
      {
        const int rr = tid >> 2;
        const int part = tid & 3;
        const int qpos = q0 + rr;
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const int col = part * 16 + c;
          const int key = k0 + col;
          float p = 0.f, ds = 0.f;
          if (qpos < Sq && key < Sk) {
            float x = ss[rr * L::LS + col];
            if (scale != 1.f) x *= scale;
            if (causal) {
              const int kpos = key + k_offset;
              bool keep = qpos >= kpos;
              if (window > 0) keep = keep && kpos > qpos - window;
              if (!keep) x = kNegInf;
            }
            p = expf(x - slse[rr]);
            ds = p * (sdp[rr * L::LS + col] - sdi[rr]);
          }
          sp[rr * L::LP + col] = __float2bfloat16(p);
          sds[rr * L::LP + col] = __float2bfloat16(ds);
        }
      }
      __syncthreads();

      // dv += p^T.do, dk += ds^T.q (rows: keys), and this pair's dq = ds.k
      // (rows: queries), over [64, DM] fragments.
#pragma unroll
      for (int i = 0; i < FPW; ++i) {
        const int f = warp + 8 * i;
        if (f >= NF) break;
        const int rb = f / NC;
        const int cb = f - rb * NC;
        FragC acc_dq;
        wmma::fill_fragment(acc_dq, 0.f);
#pragma unroll
        for (int kk = 0; kk < kBlockQ / 16; ++kk) {
          FragAT at;
          FragB bm;
          wmma::load_matrix_sync(at, sp + kk * 16 * L::LP + rb * 16, L::LP);
          wmma::load_matrix_sync(bm, sdo + kk * 16 * L::LD + cb * 16, L::LD);
          wmma::mma_sync(dv_acc[i], at, bm, dv_acc[i]);
          wmma::load_matrix_sync(at, sds + kk * 16 * L::LP + rb * 16, L::LP);
          wmma::load_matrix_sync(bm, sq + kk * 16 * L::LD + cb * 16, L::LD);
          wmma::mma_sync(dk_acc[i], at, bm, dk_acc[i]);
          FragA a;
          wmma::load_matrix_sync(a, sds + rb * 16 * L::LP + kk * 16, L::LP);
          wmma::load_matrix_sync(bm, sk + kk * 16 * L::LD + cb * 16, L::LD);
          wmma::mma_sync(acc_dq, a, bm, acc_dq);
        }
        wmma::store_matrix_sync(sdq + rb * 16 * L::LQ + cb * 16, acc_dq,
                                L::LQ, wmma::mem_row_major);
      }
      __syncthreads();

      for (int i = tid; i < kBlockQ * DM; i += kThreads) {
        const int rr = i / DM;
        const int d = i - rr * DM;
        const int row = q0 + rr;
        if (row < Sq && d < D) {
          const float x = sdq[rr * L::LQ + d];
          atomicAdd(dqb + (size_t)row * D + d, scale != 1.f ? scale * x : x);
        }
      }
    }
  }

  // Stage dk (over the dq tile) and dv (over the s / dp tiles), then write.
  __syncthreads();
  float* sdk = sdq;
  float* sdv = ss;
#pragma unroll
  for (int i = 0; i < FPW; ++i) {
    const int f = warp + 8 * i;
    if (f >= NF) break;
    const int rb = f / NC;
    const int cb = f - rb * NC;
    if (scale != 1.f) {
      for (int e = 0; e < dk_acc[i].num_elements; ++e) dk_acc[i].x[e] *= scale;
    }
    wmma::store_matrix_sync(sdk + rb * 16 * L::LQ + cb * 16, dk_acc[i], L::LQ,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(sdv + rb * 16 * L::LQ + cb * 16, dv_acc[i], L::LQ,
                            wmma::mem_row_major);
  }
  __syncthreads();
  bf16* dkb = dk + (size_t)bkv * Sk * D;
  bf16* dvb = dv + (size_t)bkv * Sk * D;
  for (int i = tid; i < kBlockK * DM; i += kThreads) {
    const int r = i / DM;
    const int d = i - r * DM;
    const int key = k0 + r;
    if (key < Sk && d < D) {
      dkb[(size_t)key * D + d] = __float2bfloat16(sdk[r * L::LQ + d]);
      dvb[(size_t)key * D + d] = __float2bfloat16(sdv[r * L::LQ + d]);
    }
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
template <int DM>
cudaError_t launch_dm(bool bf16_, const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* di,
                      void* dq, void* dk, void* dv, int B, int H, int Hkv,
                      int Sq, int Sk, int D, int causal, int window,
                      int k_offset, float scale, cudaStream_t s) {
  const dim3 grid(B * Hkv, (Sk + kBlockK - 1) / kBlockK);
  const float* l = static_cast<const float*>(lse);
  const float* r = static_cast<const float*>(di);
  float* g = static_cast<float*>(dq);
  if (bf16_) {
    return launch(flash_bwd_wmma_kernel<DM>, WmmaLayout<DM>::bytes, grid, s,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                  l, r, g, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H,
                  Hkv, Sq, Sk, D, causal, window, k_offset, scale);
  }
  return launch(flash_bwd_f32_kernel<DM>, sizeof(float) * smem_floats<DM>(),
                grid, s, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<const float*>(dout), l, r, g,
                static_cast<float*>(dk), static_cast<float*>(dv), H, Hkv, Sq,
                Sk, D, causal, window, k_offset, scale);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do, dk, dv); lse, di and dq
// are f32, dq zeroed by the caller. causal: 0 or 1; window <= 0 means no
// window. D <= 128. Returns 0 on a launched kernel, else the cudaError_t
// of the refusal.
int pddl_flash_bwd(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* di,
                   void* dq, void* dk, void* dv, int B, int H, int Hkv,
                   int Sq, int Sk, int D, int causal, int window,
                   int k_offset, float scale, int dtype, void* stream) {
  if (B < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Sk < 1 || D < 1 ||
      D > 128 || (long long)(Sk + kBlockK - 1) / kBlockK > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool b16 = dtype == 1;
  if (D <= 16)
    return (int)launch_dm<16>(b16, q, k, v, dout, lse, di, dq, dk, dv, B, H,
                              Hkv, Sq, Sk, D, causal, window, k_offset, scale,
                              s);
  if (D <= 32)
    return (int)launch_dm<32>(b16, q, k, v, dout, lse, di, dq, dk, dv, B, H,
                              Hkv, Sq, Sk, D, causal, window, k_offset, scale,
                              s);
  if (D <= 64)
    return (int)launch_dm<64>(b16, q, k, v, dout, lse, di, dq, dk, dv, B, H,
                              Hkv, Sq, Sk, D, causal, window, k_offset, scale,
                              s);
  return (int)launch_dm<128>(b16, q, k, v, dout, lse, di, dq, dk, dv, B, H,
                             Hkv, Sq, Sk, D, causal, window, k_offset, scale,
                             s);
}

const char* pddl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
