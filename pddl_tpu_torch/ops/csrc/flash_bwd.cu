// Flash-attention backward for Hopper (sm_90a): the fused single sweep (K2)
// and the two sweeps of the long-context backward (K3a dq, K3b dk/dv).
//
// Replaces the Pallas kernels of pddl_tpu/ops/attention.py launched by
// _flash_bwd_impl: _flash_bwd_fused_kernel (K2, taken when rep * Sq * D * 4
// <= 6 MiB), and _flash_bwd_dq_kernel (K3a) with _flash_bwd_dkv_kernel
// (K3b) above that. All three compute the same function. Inputs as the
// forward (q, do [B, H, Sq, D]; k, v [B, Hkv, Sk, D]; one type, f32 or
// bf16) plus the forward's lse and the row term di = rowsum(do * o) - dlse,
// both [B * H, Sq] f32, built by the caller. For every (q tile, key tile)
// pair of the causal/window band they recompute
//   s = scale * q.k (masked to NEG_INF as in the forward), p = exp(s - lse),
//   dp = do.v, ds = p * (dp - di),
// and add dv += p^T.do, dk += scale * ds^T.q, dq += scale * ds.k, with the
// reference's rounding points: p is rounded to do's type before the dv
// product, ds to q's and k's type before the dk and dq products, and every
// product accumulates in f32. dk and dv are summed over the rep = H / Hkv
// query heads of their kv head.
//
// What bounds them on an H100: the tensor cores' rate. Per tile pair K2
// runs 5 products, K3a 3 (s, dp, dq) and K3b 4 (s, dp, dv, dk), each
// 2 * 64 * 64 * D flops, over about half of the B * H * (S / 64)^2 pairs
// under a causal mask: at Llama-1B's long-context shape (B 1, H 32, S 8192,
// D 64) K3a ~412 GFLOP (~0.42 ms at 989 TFLOP/s bf16) and K3b ~550 GFLOP
// (~0.56 ms). The design is the simple one, on 256 threads (8 warps):
//  - K2 and K3b: one block per (b * hkv, 64-key tile) holds its K and V
//    tiles in shared memory and its dk / dv accumulators for the whole
//    sweep; a loop over the group's query heads and the q tiles in the band
//    (the forward's band arithmetic seen from the keys) takes the place of
//    the TPU's sequential inner grid axis. K3b is K2's kernel with the dq
//    product and its atomics compiled out (template flag kDq);
//  - K2's dq: the TPU kernel keeps a whole-sequence dq scratch in VMEM and
//    relies on the grid running in order. Hopper blocks run concurrently,
//    so each block adds its [64, D] dq contribution for a q tile with f32
//    atomicAdd into a [B * H, Sq, D] f32 buffer the caller zeroes and casts.
//    The order of those additions changes from run to run, so K2's dq is
//    NOT bitwise reproducible;
//  - K3a: one block per (b * h, 64-row q tile) holds its q, do, lse and di
//    rows and loops over the key tiles of the forward's band, keeping its
//    dq accumulator in the block for the whole sweep; dq is written once,
//    in q's type, with no atomics, so it IS bitwise reproducible;
//  - bf16 (the training path): the products run on the tensor cores as
//    WMMA 16x16x16 bf16 fragments with f32 accumulation; s and dp go
//    through shared memory for the elementwise p / ds pass, which stores p
//    and ds as bf16 (the rounding points above) for the following products;
//    the sweep's accumulators stay in fragments;
//  - f32: the products run on the f32 FMA units (rows of K / V padded by
//    one against bank conflicts), the accumulators in registers;
//  - ragged Sq / Sk edges are masked here (p = ds = 0 outside the arrays).
// The heaviest tiles launch first: the first key tiles (K2, K3b) and the
// last q tiles (K3a) under a causal mask.

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

// K2 (kDq) and K3b in f32: every product on the FMA units.
template <int DM, bool kDq>
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

      // This pair's dq rows (K2 only): ds.k for rows ty*4+i, columns
      // tx+16*j, added to the f32 dq buffer.
      if constexpr (kDq) {
        float* dqb = dq + (size_t)bh * Sq * D;
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
              const float x = scale != 1.f ? scale * dq_acc[i][j]
                                           : dq_acc[i][j];
              atomicAdd(dqb + (size_t)row * D + d, x);
            }
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

// K2 (kDq) and K3b in bf16, on the tensor cores.
template <int DM, bool kDq>
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

      // dv += p^T.do, dk += ds^T.q (rows: keys), and (K2) this pair's
      // dq = ds.k (rows: queries), over [64, DM] fragments.
#pragma unroll
      for (int i = 0; i < FPW; ++i) {
        const int f = warp + 8 * i;
        if (f >= NF) break;
        const int rb = f / NC;
        const int cb = f - rb * NC;
        FragC acc_dq;
        if constexpr (kDq) wmma::fill_fragment(acc_dq, 0.f);
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
          if constexpr (kDq) {
            FragA a;
            wmma::load_matrix_sync(a, sds + rb * 16 * L::LP + kk * 16, L::LP);
            wmma::load_matrix_sync(bm, sk + kk * 16 * L::LD + cb * 16, L::LD);
            wmma::mma_sync(acc_dq, a, bm, acc_dq);
          }
        }
        if constexpr (kDq) {
          wmma::store_matrix_sync(sdq + rb * 16 * L::LQ + cb * 16, acc_dq,
                                  L::LQ, wmma::mem_row_major);
        }
      }

      if constexpr (kDq) {
        __syncthreads();
        float* dqb = dq + (size_t)bh * Sq * D;
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

// The key tiles whose keys some row of the q tile at q0 sees: the forward's
// band (_block_in_band's arithmetic), [*kt_begin, *kt_end).
__device__ __forceinline__ void key_band(int q0, int Sq, int Sk, int causal,
                                         int window, int k_offset,
                                         int* kt_begin, int* kt_end) {
  *kt_begin = 0;
  *kt_end = (Sk + kBlockK - 1) / kBlockK;
  if (causal) {
    const int q_last = min(q0 + kBlockQ - 1, Sq - 1);
    *kt_end = min(*kt_end, max(0, floor_div(q_last - k_offset, kBlockK) + 1));
    if (window > 0) {
      *kt_begin = max(0, floor_div(q0 - window + 1 - k_offset, kBlockK));
    }
  }
}

// K3a in f32: the dq sweep on the FMA units. One block per (b * h, 64-row
// q tile), the late (heavy) tiles first; the thread at (ty, tx) owns dq
// rows ty*4+i, columns tx+16*j for the whole sweep.
template <int DM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, float* __restrict__ dq,
                        int H, int Hkv, int Sq, int Sk, int D, int causal,
                        int window, int k_offset, float scale) {
  constexpr int KS = DM + 1;
  constexpr int NJ = DM / 16;
  extern __shared__ float smem[];
  float* sq = smem;                       // [64][DM]
  float* sdo = sq + kBlockQ * DM;         // [64][DM]
  float* sk = sdo + kBlockQ * DM;         // [64][DM + 1]
  float* sv = sk + kBlockK * KS;          // [64][DM + 1]
  float* sds = sv + kBlockK * KS;         // [64 q][65] ds
  float* slse = sds + kBlockQ * kPS;      // [64]
  float* sdi = slse + kBlockQ;            // [64]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int bkv = b * Hkv + (bh - b * H) / (H / Hkv);
  const int nq = (Sq + kBlockQ - 1) / kBlockQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * kBlockQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  const float* qb = q + (size_t)bh * Sq * D;
  const float* dob = dout + (size_t)bh * Sq * D;
  const float* kb = k + (size_t)bkv * Sk * D;
  const float* vb = v + (size_t)bkv * Sk * D;
  for (int i = tid; i < kBlockQ * DM; i += kThreads) {
    const int r = i / DM;
    const int d = i - r * DM;
    const int row = q0 + r;
    const bool ok = row < Sq && d < D;
    sq[i] = ok ? qb[(size_t)row * D + d] : 0.f;
    sdo[i] = ok ? dob[(size_t)row * D + d] : 0.f;
  }
  if (tid < kBlockQ) {
    const int row = q0 + tid;
    slse[tid] = row < Sq ? lse[(size_t)bh * Sq + row] : 0.f;
    sdi[tid] = row < Sq ? di[(size_t)bh * Sq + row] : 0.f;
  }

  int kt_begin, kt_end;
  key_band(q0, Sq, Sk, causal, window, k_offset, &kt_begin, &kt_end);

  float dq_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq_acc[i][j] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile is done with sk / sv / sds
    for (int i = tid; i < kBlockK * DM; i += kThreads) {
      const int r = i / DM;
      const int d = i - r * DM;
      const int key = k0 + r;
      const bool ok = key < Sk && d < D;
      sk[r * KS + d] = ok ? kb[(size_t)key * D + d] : 0.f;
      sv[r * KS + d] = ok ? vb[(size_t)key * D + d] : 0.f;
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
        float ds = 0.f;
        if (qpos < Sq && key < Sk) {
          float val = scale != 1.f ? scale * s[i][j] : s[i][j];
          if (causal) {
            const int kpos = key + k_offset;
            bool keep = qpos >= kpos;
            if (window > 0) keep = keep && kpos > qpos - window;
            if (!keep) val = kNegInf;
          }
          ds = expf(val - slse[rr]) * (dp[i][j] - sdi[rr]);
        }
        sds[rr * kPS + c] = ds;
      }
    }
    __syncthreads();

    // dq += ds.k for rows ty*4+i, columns tx+16*j.
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
  }

  float* dqb = dq + (size_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        const float x = dq_acc[i][j];
        dqb[(size_t)row * D + d] = scale != 1.f ? scale * x : x;
      }
    }
  }
}

// Shared-memory layout of K3a's tensor-core kernel: q, do, k, v tiles
// (bf16), s and dp (f32), ds (bf16), lse and di rows; the finished dq is
// staged over the s / dp tiles.
template <int DM>
struct DqLayout {
  static constexpr int LD = DM + 8;
  static constexpr int LS = kBlockK + 4;
  static constexpr int LP = kBlockK + 8;
  static constexpr int LQ = DM + 4;
  static constexpr size_t bytes =
      4 * kBlockQ * LD * sizeof(bf16) + 2 * kBlockQ * LS * sizeof(float) +
      kBlockQ * LP * sizeof(bf16) + 2 * kBlockQ * sizeof(float);
  static_assert(kBlockQ * LQ <= 2 * kBlockQ * LS,
                "dq staging reuses the s / dp tiles");
};

// K3a in bf16: the dq sweep on the tensor cores, dq in [64, DM] accumulator
// fragments for the whole sweep.
template <int DM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wmma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, bf16* __restrict__ dq,
                         int H, int Hkv, int Sq, int Sk, int D, int causal,
                         int window, int k_offset, float scale) {
  using L = DqLayout<DM>;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                               wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                               wmma::row_major>;
  using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                                wmma::col_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  constexpr int NC = DM / 16;
  constexpr int NF = 4 * NC;
  constexpr int FPW = NF >= 8 ? NF / 8 : 1;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + kBlockQ * L::LD;
  bf16* sk = sdo + kBlockQ * L::LD;
  bf16* sv = sk + kBlockK * L::LD;
  float* ss = reinterpret_cast<float*>(sv + kBlockK * L::LD);
  float* sdp = ss + kBlockQ * L::LS;
  bf16* sds = reinterpret_cast<bf16*>(sdp + kBlockQ * L::LS);
  float* slse = reinterpret_cast<float*>(sds + kBlockQ * L::LP);
  float* sdi = slse + kBlockQ;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int bkv = b * Hkv + (bh - b * H) / (H / Hkv);
  const int nq = (Sq + kBlockQ - 1) / kBlockQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  load_tile<DM>(sq, L::LD, q + (size_t)bh * Sq * D, q0, Sq, D);
  load_tile<DM>(sdo, L::LD, dout + (size_t)bh * Sq * D, q0, Sq, D);
  if (tid < kBlockQ) {
    const int row = q0 + tid;
    slse[tid] = row < Sq ? lse[(size_t)bh * Sq + row] : 0.f;
    sdi[tid] = row < Sq ? di[(size_t)bh * Sq + row] : 0.f;
  }
  const bf16* kb = k + (size_t)bkv * Sk * D;
  const bf16* vb = v + (size_t)bkv * Sk * D;

  int kt_begin, kt_end;
  key_band(q0, Sq, Sk, causal, window, k_offset, &kt_begin, &kt_end);

  FragC dq_acc[FPW];
#pragma unroll
  for (int i = 0; i < FPW; ++i) wmma::fill_fragment(dq_acc[i], 0.f);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile is done with sk / sv / sds
    load_tile<DM>(sk, L::LD, kb, k0, Sk, D);
    load_tile<DM>(sv, L::LD, vb, k0, Sk, D);
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
      wmma::store_matrix_sync(sdp + rb * 16 * L::LS + cb * 16, acc_dp, L::LS,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // ds = exp(s - lse) * (dp - di), stored as bf16.
    {
      const int rr = tid >> 2;
      const int part = tid & 3;
      const int qpos = q0 + rr;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int col = part * 16 + c;
        const int key = k0 + col;
        float ds = 0.f;
        if (qpos < Sq && key < Sk) {
          float x = ss[rr * L::LS + col];
          if (scale != 1.f) x *= scale;
          if (causal) {
            const int kpos = key + k_offset;
            bool keep = qpos >= kpos;
            if (window > 0) keep = keep && kpos > qpos - window;
            if (!keep) x = kNegInf;
          }
          ds = expf(x - slse[rr]) * (sdp[rr * L::LS + col] - sdi[rr]);
        }
        sds[rr * L::LP + col] = __float2bfloat16(ds);
      }
    }
    __syncthreads();

    // dq += ds.k over [64, DM] fragments.
#pragma unroll
    for (int i = 0; i < FPW; ++i) {
      const int f = warp + 8 * i;
      if (f >= NF) break;
      const int rb = f / NC;
      const int cb = f - rb * NC;
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        FragA a;
        FragB bm;
        wmma::load_matrix_sync(a, sds + rb * 16 * L::LP + kk * 16, L::LP);
        wmma::load_matrix_sync(bm, sk + kk * 16 * L::LD + cb * 16, L::LD);
        wmma::mma_sync(dq_acc[i], a, bm, dq_acc[i]);
      }
    }
  }

  // Stage dq over the s / dp tiles, then write it in q's type.
  __syncthreads();
  float* sdq = ss;
#pragma unroll
  for (int i = 0; i < FPW; ++i) {
    const int f = warp + 8 * i;
    if (f >= NF) break;
    const int rb = f / NC;
    const int cb = f - rb * NC;
    if (scale != 1.f) {
      for (int e = 0; e < dq_acc[i].num_elements; ++e) dq_acc[i].x[e] *= scale;
    }
    wmma::store_matrix_sync(sdq + rb * 16 * L::LQ + cb * 16, dq_acc[i], L::LQ,
                            wmma::mem_row_major);
  }
  __syncthreads();
  bf16* dqb = dq + (size_t)bh * Sq * D;
  for (int i = tid; i < kBlockQ * DM; i += kThreads) {
    const int r = i / DM;
    const int d = i - r * DM;
    const int row = q0 + r;
    if (row < Sq && d < D) {
      dqb[(size_t)row * D + d] = __float2bfloat16(sdq[r * L::LQ + d]);
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

// One backward call's operands, as the C entries take them.
struct Bwd {
  const void *q, *k, *v, *dout, *lse, *di;
  void *dq, *dk, *dv;
  int B, H, Hkv, Sq, Sk, D, causal, window, k_offset;
  float scale;
  bool b16;
  cudaStream_t stream;
};

// The key-side sweep at one padded head width DM: K2 (kDq, dq into the f32
// buffer a.dq) or K3b (a.dq unused).
template <int DM, bool kDq>
cudaError_t launch_kv_sweep(const Bwd& a) {
  const dim3 grid(a.B * a.Hkv, (a.Sk + kBlockK - 1) / kBlockK);
  const float* l = static_cast<const float*>(a.lse);
  const float* r = static_cast<const float*>(a.di);
  float* g = static_cast<float*>(a.dq);
  if (a.b16) {
    return launch(flash_bwd_wmma_kernel<DM, kDq>, WmmaLayout<DM>::bytes, grid,
                  a.stream, static_cast<const bf16*>(a.q),
                  static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
                  static_cast<const bf16*>(a.dout), l, r, g,
                  static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H,
                  a.Hkv, a.Sq, a.Sk, a.D, a.causal, a.window, a.k_offset,
                  a.scale);
  }
  return launch(flash_bwd_f32_kernel<DM, kDq>,
                sizeof(float) * smem_floats<DM>(), grid, a.stream,
                static_cast<const float*>(a.q), static_cast<const float*>(a.k),
                static_cast<const float*>(a.v),
                static_cast<const float*>(a.dout), l, r, g,
                static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.H,
                a.Hkv, a.Sq, a.Sk, a.D, a.causal, a.window, a.k_offset,
                a.scale);
}

// The query-side sweep K3a at one padded head width DM (dq in q's type).
template <int DM>
cudaError_t launch_q_sweep(const Bwd& a) {
  const dim3 grid(a.B * a.H, (a.Sq + kBlockQ - 1) / kBlockQ);
  const float* l = static_cast<const float*>(a.lse);
  const float* r = static_cast<const float*>(a.di);
  if (a.b16) {
    return launch(flash_bwd_dq_wmma_kernel<DM>, DqLayout<DM>::bytes, grid,
                  a.stream, static_cast<const bf16*>(a.q),
                  static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
                  static_cast<const bf16*>(a.dout), l, r,
                  static_cast<bf16*>(a.dq), a.H, a.Hkv, a.Sq, a.Sk, a.D,
                  a.causal, a.window, a.k_offset, a.scale);
  }
  constexpr size_t floats = 2 * (size_t)kBlockQ * DM +
                            2 * (size_t)kBlockK * (DM + 1) +
                            (size_t)kBlockQ * kPS + 2 * (size_t)kBlockQ;
  return launch(flash_bwd_dq_f32_kernel<DM>, sizeof(float) * floats, grid,
                a.stream, static_cast<const float*>(a.q),
                static_cast<const float*>(a.k), static_cast<const float*>(a.v),
                static_cast<const float*>(a.dout), l, r,
                static_cast<float*>(a.dq), a.H, a.Hkv, a.Sq, a.Sk, a.D,
                a.causal, a.window, a.k_offset, a.scale);
}

enum class Sweep { kFused, kDkv, kDq };

template <Sweep W, int DM>
cudaError_t launch_sweep(const Bwd& a) {
  if constexpr (W == Sweep::kDq) {
    return launch_q_sweep<DM>(a);
  } else {
    return launch_kv_sweep<DM, W == Sweep::kFused>(a);
  }
}

// Check the arguments, then launch sweep W at the padded head width for D.
template <Sweep W>
int run(const Bwd& a, int dtype) {
  const int tiles = W == Sweep::kDq ? (a.Sq + kBlockQ - 1) / kBlockQ
                                    : (a.Sk + kBlockK - 1) / kBlockK;
  if (a.B < 1 || a.Hkv < 1 || a.H % a.Hkv != 0 || a.Sq < 1 || a.Sk < 1 ||
      a.D < 1 || a.D > 128 || tiles > 65535 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.D <= 16) return (int)launch_sweep<W, 16>(a);
  if (a.D <= 32) return (int)launch_sweep<W, 32>(a);
  if (a.D <= 64) return (int)launch_sweep<W, 64>(a);
  return (int)launch_sweep<W, 128>(a);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do, and the outputs dk, dv and
// K3a's dq); lse and di are f32. causal: 0 or 1; window <= 0 means no
// window. D <= 128. Each returns 0 on a launched kernel, else the
// cudaError_t of the refusal.

// K2: dq is an f32 buffer the caller zeroes (and casts to q's type).
int pddl_flash_bwd(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* di,
                   void* dq, void* dk, void* dv, int B, int H, int Hkv,
                   int Sq, int Sk, int D, int causal, int window,
                   int k_offset, float scale, int dtype, void* stream) {
  const Bwd a{q, k, v, dout, lse, di, dq, dk, dv, B, H, Hkv, Sq, Sk, D,
              causal, window, k_offset, scale, dtype == 1,
              static_cast<cudaStream_t>(stream)};
  return run<Sweep::kFused>(a, dtype);
}

// K3a: dq [B, H, Sq, D] in q's type, every element written.
int pddl_flash_bwd_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* di,
                      void* dq, int B, int H, int Hkv, int Sq, int Sk, int D,
                      int causal, int window, int k_offset, float scale,
                      int dtype, void* stream) {
  const Bwd a{q, k, v, dout, lse, di, dq, nullptr, nullptr, B, H, Hkv, Sq,
              Sk, D, causal, window, k_offset, scale, dtype == 1,
              static_cast<cudaStream_t>(stream)};
  return run<Sweep::kDq>(a, dtype);
}

// K3b: dk, dv [B, Hkv, Sk, D] in k's type, every element written.
int pddl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* di,
                       void* dk, void* dv, int B, int H, int Hkv, int Sq,
                       int Sk, int D, int causal, int window, int k_offset,
                       float scale, int dtype, void* stream) {
  const Bwd a{q, k, v, dout, lse, di, nullptr, dk, dv, B, H, Hkv, Sq, Sk, D,
              causal, window, k_offset, scale, dtype == 1,
              static_cast<cudaStream_t>(stream)};
  return run<Sweep::kDkv>(a, dtype);
}

const char* pddl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
