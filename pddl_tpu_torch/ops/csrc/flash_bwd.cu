// Flash-attention backward for Hopper (sm_90a): the fused single sweep (K2)
// and the two sweeps of the long-context backward (K3a dq, K3b dk/dv).
//
// Replaces the Pallas kernels of pddl_tpu/ops/attention.py launched by
// _flash_bwd_impl: _flash_bwd_fused_kernel (K2, :617, taken when
// rep * Sq * D * 4 <= 6 MiB), and _flash_bwd_dq_kernel (K3a, :551) with
// _flash_bwd_dkv_kernel (K3b, :578) above that. All three compute the same
// function. Inputs as the forward (q, do [B, H, Sq, D]; k, v [B, Hkv, Sk,
// D]; one type, f32 or bf16) plus the forward's lse and the row term
// di = rowsum(do * o) - dlse, both [B * H, Sq] f32, built by the caller.
// For every (q tile, key tile) pair of the causal/window band they
// recompute
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
// 2 * Bq * Bk * D flops, over about half of the pairs under a causal mask:
// at Llama-1B's training shape (B 4, H 32/8, S 2048, D 64) K2 ~172 GFLOP,
// 0.174 ms at 989 TFLOP/s bf16; at its long-context shape (B 1, S 8192) K3a
// ~412 GFLOP (0.417 ms) and K3b ~550 GFLOP (0.556 ms). Replacing the
// Pallas kernels block by block would leave them bound instead by shared
// memory traffic and barriers, since Hopper blocks neither run in order nor
// hold a whole-sequence scratch. The design:
//  - K2 and K3b in bf16 (the training path), the kv sweep: one block per
//    (b * hkv, 128-key block), on 4 warps of 32 keys (8 warps of 16 keys at
//    D 128), two blocks an SM. A warp keeps the A fragments of its K rows
//    (ldmatrix) and its dk / dv accumulators in registers for the whole
//    sweep, which loops over the group's rep query heads and the 64-row q
//    tiles of the band (q_band, the forward's band seen from the keys) —
//    the loop takes the place of the TPU's sequential inner grid axis. Per
//    16-row slice of a q tile a warp forms s^T = K.q^T and dp^T = V.do^T
//    with mma.sync m16n8k16 (q and do as B fragments from shared memory,
//    each feeding the warp's two 16-key m-tiles), then p^T and ds^T from
//    the slice's lse and di, rounded to bf16 straight into the A fragments
//    of dv += p^T.do and dk += ds^T.q (do and q as .trans B fragments): no
//    s, dp, p or ds tile goes through shared memory. The next q tile, do
//    tile and their lse / di rows load with cp.async while this one is
//    computed (double buffer, one barrier per q tile); only the tiles that
//    cross the diagonal, the window edge or a ragged edge take the mask
//    (needs_mask_kv). dk and dv are summed over the query group inside the
//    block and written once, in k's type, with no atomics, so they are
//    bitwise reproducible. K3b is K2 with the dq product compiled out
//    (template flag kDq);
//  - K2's dq: the TPU kernel keeps a whole-sequence dq scratch in VMEM and
//    relies on the grid running in order. Here each warp also writes its
//    ds^T rows in bf16 to one shared [keys][q] tile; after a second
//    barrier the warps split the q tile two by two (32 rows x 32 columns
//    each at D 64) and compute ds.k on the tensor cores (ds by .trans from
//    that tile, K as .trans B fragments), adding the f32 result to a
//    [B * H, Sq, D] buffer the caller zeroes and casts, with 8-byte
//    reductions. The order of the additions changes from run to run, so
//    K2's dq is NOT bitwise reproducible;
//  - K3a: one block per (b * h, q tile) holds its q, do, lse and di rows
//    and loops over the key tiles of the forward's band, keeping its dq
//    accumulator for the whole sweep; dq is written once, in q's type, with
//    no atomics, so it IS bitwise reproducible. In bf16 it is
//    register-resident, as K1 is (flash_common.cuh): 128-row q tiles,
//    32 rows per warp at D <= 64 (16 at D 128); q's and do's A fragments
//    stay in registers; s and dp of each 16-key slice stay in registers,
//    where ds is formed from the rows' lse and di and rounded to bf16 as
//    the A fragment of ds.k; the K / V tiles are double-buffered with
//    cp.async (one barrier per key tile);
//  - f32: the products run on the f32 FMA units (rows of K / V padded by
//    one against bank conflicts), the accumulators in registers;
//  - ragged Sq / Sk edges are masked here (p = ds = 0 outside the arrays).
// The heaviest tiles launch first: the first key blocks (K2, K3b) and the
// last q tiles (K3a) under a causal mask.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "flash_common.cuh"

namespace {

using namespace pddl_flash;

// The f32 kernels tile by 64 rows and 64 keys. In bf16, K3a takes the
// mma.sync kernels' 128-row tiles (kMmaBlockQ, flash_common.cuh) and K2 /
// K3b the kv sweep's blocks of kKvBlockK keys against 64-row q tiles.
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kPS = kBlockK + 1;

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

  int qt_begin, qt_end;
  q_band<kBlockQ, kBlockK>(k0, Sq, Sk, causal, window, k_offset, &qt_begin,
                           &qt_end);

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

// The kv sweep in bf16 (K2 with kDq, K3b without): a block owns kKvBlockK
// keys for the whole sweep and walks the rep query heads of their kv head
// and the kKvBlockQ-row q tiles of the band (q_band). A warp owns MT
// m-tiles of 16 keys: two where registers allow (DM <= 64), so that every
// q and do fragment read from shared memory feeds two products, on 4 warps
// with two blocks an SM; one at DM 128, on 8 warps.
constexpr int kKvBlockK = 128;
constexpr int kKvBlockQ = 64;

template <int DM>
struct KvShape {
  static constexpr int MT = DM <= 64 ? 2 : 1;
  static constexpr int kWarps = kKvBlockK / (16 * MT);
  static constexpr int kThreads = 32 * kWarps;
};

// Shared memory of the kv sweep: the K and V blocks, two q and two do tiles
// (double buffer), two sets of the tiles' lse and di rows, and (K2) the
// block's ds^T in bf16 for the dq product. bf16 rows are padded by 16 bytes
// so that ldmatrix has no bank conflicts. At DM 64: 74,752 bytes for K3b,
// 93,184 for K2, so two blocks fit an SM.
template <int DM, bool kDq>
struct KvLayout {
  static constexpr int LD = DM + 8;           // K, V, q, do rows
  static constexpr int LS = kKvBlockQ + 8;    // ds^T rows (keys)
  static constexpr size_t bytes =
      (size_t)(2 * kKvBlockK + 4 * kKvBlockQ) * LD * sizeof(bf16) +
      4 * kKvBlockQ * sizeof(float) +
      (kDq ? (size_t)kKvBlockK * LS * sizeof(bf16) : 0);
};

// Stage the lse and di of rows [q0, q0 + BQ) into dst[0, BQ) and
// dst[BQ, 2 BQ), zero past Sq, with cp.async (the caller commits).
template <int BQ, int THREADS>
__device__ __forceinline__ void load_row_terms(float* dst, const float* lse,
                                               const float* di, int q0,
                                               int Sq) {
  for (int i = threadIdx.x; i < 2 * BQ; i += THREADS) {
    const int r = i < BQ ? i : i - BQ;
    const float* src = i < BQ ? lse : di;
    const bool ok = q0 + r < Sq;
    cp_async_4(dst + i, ok ? src + q0 + r : src, ok);
  }
}

// Add a thread's two adjacent f32 values at columns col, col + 1 (col even)
// of an f32 row, within [0, D): one 8-byte reduction where D is even (the
// row and col then keep it aligned), else one value at a time. The results
// are unused, so these compile to reductions (RED), not atomics that wait.
__device__ __forceinline__ void red_pair(float* row, int col, int D, float x0,
                                         float x1) {
  if ((D & 1) == 0) {
    if (col < D) {
      atomicAdd(reinterpret_cast<float2*>(row + col), make_float2(x0, x1));
    }
    return;
  }
  if (col < D) atomicAdd(row + col, x0);
  if (col + 1 < D) atomicAdd(row + col + 1, x1);
}

// K2 (kDq) and K3b in bf16: the kv-stationary sweep on the tensor cores,
// register-resident. A warp holds the A fragments of its K rows and its
// dk / dv accumulators in registers for the whole sweep (V's fragments come
// from shared memory: holding them too spills at DM 64); for each 16-row
// slice of a q tile it forms s^T = K.q^T and dp^T = V.do^T (q and do as B
// fragments from shared memory), then p^T = exp(s^T - lse) and
// ds^T = p^T (dp^T - di) from the slice's lse and di, rounds both to bf16
// as the A fragments of dv += p^T.do and dk += ds^T.q (do and q as .trans
// B fragments). K2 also writes ds^T to shared memory; after one barrier the
// warps split the q tile two by two and add dq = ds.k to the f32 buffer.
template <int DM, bool kDq>
__global__ void __launch_bounds__(KvShape<DM>::kThreads, 1)
flash_bwd_kv_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, float* __restrict__ dq,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                        int Hkv, int Sq, int Sk, int D, int causal, int window,
                        int k_offset, float scale) {
  constexpr int LD = KvLayout<DM, kDq>::LD;
  constexpr int LS = KvLayout<DM, kDq>::LS;
  constexpr int BK = kKvBlockK;
  constexpr int BQ = kKvBlockQ;
  constexpr int MT = KvShape<DM>::MT;
  constexpr int NW = KvShape<DM>::kWarps;
  constexpr int NT = KvShape<DM>::kThreads;
  constexpr int KK = DM / 16;              // k-steps of K.q^T and V.do^T
  constexpr int NO = DM / 8;               // n-tiles of a dk / dv row block
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + BK * LD;
  bf16* sq = sv + BK * LD;                 // [2][BQ][LD]
  bf16* sdo = sq + 2 * BQ * LD;            // [2][BQ][LD]
  float* srow = reinterpret_cast<float*>(sdo + 2 * BQ * LD);  // [2][2][BQ]
  bf16* sds = reinterpret_cast<bf16*>(srow + 4 * BQ);  // [BK][LS]

  const int bkv = blockIdx.x;
  const int b = bkv / Hkv;
  const int hk = bkv - b * Hkv;
  const int rep = H / Hkv;
  const int k0 = blockIdx.y * BK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = 16 * MT * warp;         // the warp's first key in the block
  const bool vec = D % 8 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(dout);

  int qt_begin, qt_end;
  q_band<BQ, BK>(k0, Sq, Sk, causal, window, k_offset, &qt_begin, &qt_end);
  const int nqt = max(0, qt_end - qt_begin);
  const int steps = rep * nqt;             // (query head, q tile) pairs

  // Stage step `it`'s q and do tiles and row terms into buffer `buf`.
  auto stage = [&](int it, int buf) {
    const int r = it / nqt;
    const int q0 = (qt_begin + it - r * nqt) * BQ;
    const size_t bh = (size_t)b * H + hk * rep + r;
    load_rows<DM, BQ, NT>(sq + buf * BQ * LD, q + bh * Sq * D, q0, Sq, D,
                          vec);
    load_rows<DM, BQ, NT>(sdo + buf * BQ * LD, dout + bh * Sq * D, q0, Sq, D,
                          vec);
    load_row_terms<BQ, NT>(srow + buf * 2 * BQ, lse + bh * Sq, di + bh * Sq,
                           q0, Sq);
  };

  load_rows<DM, BK, NT>(sk, k + (size_t)bkv * Sk * D, k0, Sk, D, vec);
  load_rows<DM, BK, NT>(sv, v + (size_t)bkv * Sk * D, k0, Sk, D, vec);
  if (steps > 0) stage(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t kf[MT][KK][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const int off = a_offset<LD>(lane, wrow + 16 * mt, kk * 16);
      ldmatrix_x4(kf[mt][kk], sk + off);
    }

  float dk_acc[MT][NO][4], dv_acc[MT][NO][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[mt][n][e] = dv_acc[mt][n][e] = 0.f;
  // exp(scale * s - lse) as one FMA and exp2 on the tiles that need no mask.
  const float s_log2 = scale * kLog2e;

  for (int it = 0; it < steps; ++it) {
    const int buf = it & 1;
    if (it > 0) {
      cp_async_wait_all();
      __syncthreads();  // step it landed; every warp is done with step it-1
    }
    if (it + 1 < steps) stage(it + 1, buf ^ 1);
    cp_async_commit();

    const int r = it / nqt;
    const int q0 = (qt_begin + it - r * nqt) * BQ;
    const bf16* sqt = sq + buf * BQ * LD;
    const bf16* sdot = sdo + buf * BQ * LD;
    const float* slse = srow + buf * 2 * BQ;
    const float* sdi = slse + BQ;
    bool masked[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      masked[mt] = needs_mask_kv<BQ>(k0 + wrow + 16 * mt, q0, Sq, Sk, causal,
                                     window, k_offset);
    }

    // Not unrolled: unrolled, the slices' registers spill at DM 64 and K2
    // runs slower.
#pragma unroll 1
    for (int j = 0; j < BQ / 16; ++j) {
      // s^T and dp^T for q rows q0 + 16j .. q0 + 16j + 15: two n-tiles each.
      float s[MT][2][4], dp[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][n][e] = dp[mt][n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        uint32_t bf[4];
        ldmatrix_x4(bf, sqt + b_offset<LD>(lane, j * 16, kk * 16));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16816(s[mt][0], kf[mt][kk], bf[0], bf[1]);
          mma_16816(s[mt][1], kf[mt][kk], bf[2], bf[3]);
        }
        ldmatrix_x4(bf, sdot + b_offset<LD>(lane, j * 16, kk * 16));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t va[4];
          ldmatrix_x4(va, sv + a_offset<LD>(lane, wrow + 16 * mt, kk * 16));
          mma_16816(dp[mt][0], va, bf[0], bf[1]);
          mma_16816(dp[mt][1], va, bf[2], bf[3]);
        }
      }

      // p^T = exp(s^T - lse), ds^T = p^T (dp^T - di), by the columns' rows;
      // both rounded to bf16 as A fragments over these 16 q rows.
      uint32_t pa[MT][4], da[MT][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int c = j * 16 + n * 8 + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(slse + c);
        const float2 d2 = *reinterpret_cast<const float2*>(sdi + c);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float l = (e & 1) ? l2.y : l2.x;
            float p;
            if (masked[mt]) {
              const int key = k0 + wrow + 16 * mt + g + 8 * (e >> 1);
              const int qpos = q0 + c + (e & 1);
              p = 0.f;
              if (key < Sk && qpos < Sq) {
                float x = scale != 1.f ? scale * s[mt][n][e] : s[mt][n][e];
                if (causal && !keeps(qpos, key + k_offset, window)) {
                  x = kNegInf;
                }
                p = exp2_approx((x - l) * kLog2e);
              }
            } else {
              p = exp2_approx(fmaf(s[mt][n][e], s_log2, -l * kLog2e));
            }
            s[mt][n][e] = p;
            dp[mt][n][e] = p * (dp[mt][n][e] - ((e & 1) ? d2.y : d2.x));
          }
          pa[mt][2 * n] = pack_bf16(s[mt][n][0], s[mt][n][1]);
          pa[mt][2 * n + 1] = pack_bf16(s[mt][n][2], s[mt][n][3]);
          da[mt][2 * n] = pack_bf16(dp[mt][n][0], dp[mt][n][1]);
          da[mt][2 * n + 1] = pack_bf16(dp[mt][n][2], dp[mt][n][3]);
        }
      }
      if constexpr (kDq) {
        // ds^T rows g and g + 8 of each m-tile, columns 16j + 2t (n-tile 0)
        // and 16j + 8 + 2t (n-tile 1).
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          bf16* row = sds + (wrow + 16 * mt + g) * LS + j * 16 + 2 * t;
          *reinterpret_cast<uint32_t*>(row) = da[mt][0];
          *reinterpret_cast<uint32_t*>(row + 8 * LS) = da[mt][1];
          *reinterpret_cast<uint32_t*>(row + 8) = da[mt][2];
          *reinterpret_cast<uint32_t*>(row + 8 * LS + 8) = da[mt][3];
        }
      }

      // dv += p^T.do, dk += ds^T.q over these 16 q rows.
#pragma unroll
      for (int p = 0; p < DM / 16; ++p) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, sdot + bt_offset<LD>(lane, j * 16, p * 16));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16816(dv_acc[mt][2 * p], pa[mt], bf[0], bf[1]);
          mma_16816(dv_acc[mt][2 * p + 1], pa[mt], bf[2], bf[3]);
        }
        ldmatrix_x4_trans(bf, sqt + bt_offset<LD>(lane, j * 16, p * 16));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16816(dk_acc[mt][2 * p], da[mt], bf[0], bf[1]);
          mma_16816(dk_acc[mt][2 * p + 1], da[mt], bf[2], bf[3]);
        }
      }
    }

    if constexpr (kDq) {
      // dq = ds.k for the tile's rows from ds^T in sds, added to the f32
      // buffer. The warps split the tile WQ x WD: each takes MPW 16-row
      // m-tiles and CPW 16-column blocks, so that each ds fragment feeds CPW
      // products and each K fragment MPW.
      __syncthreads();  // every warp's ds^T rows are in sds
      constexpr int MQ = BQ / 16;
      constexpr int NC = DM / 16;
      constexpr int WD = NC >= 2 ? 2 : 1;
      constexpr int WQ = NW / WD;
      constexpr int MPW = MQ / WQ;
      constexpr int CPW = NC / WD;
      static_assert(NW % WD == 0 && MQ % WQ == 0 && MPW >= 1,
                    "the dq product splits evenly over the warps");
      const int m0 = (warp % WQ) * MPW;
      const int c0 = (warp / WQ) * CPW;
      float acc[MPW][CPW][2][4];
  #pragma unroll
      for (int m = 0; m < MPW; ++m)
  #pragma unroll
        for (int c = 0; c < CPW; ++c)
  #pragma unroll
          for (int n = 0; n < 2; ++n)
  #pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][c][n][e] = 0.f;
  #pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        // ds (rows q, columns keys) from the [keys][q] tile, transposed.
        uint32_t a[MPW][4];
  #pragma unroll
        for (int m = 0; m < MPW; ++m) {
          ldmatrix_x4_trans(a[m],
                            sds + b_offset<LS>(lane, ks * 16, (m0 + m) * 16));
        }
  #pragma unroll
        for (int c = 0; c < CPW; ++c) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf,
                            sk + bt_offset<LD>(lane, ks * 16, (c0 + c) * 16));
  #pragma unroll
          for (int m = 0; m < MPW; ++m) {
            mma_16816(acc[m][c][0], a[m], bf[0], bf[1]);
            mma_16816(acc[m][c][1], a[m], bf[2], bf[3]);
          }
        }
      }
      float* dqb = dq + ((size_t)b * H + hk * rep + r) * Sq * D;
  #pragma unroll
      for (int m = 0; m < MPW; ++m)
  #pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = q0 + (m0 + m) * 16 + g + 8 * i;
          if (row >= Sq) continue;
  #pragma unroll
          for (int c = 0; c < CPW; ++c)
  #pragma unroll
            for (int n = 0; n < 2; ++n) {
              float x0 = acc[m][c][n][2 * i], x1 = acc[m][c][n][2 * i + 1];
              if (scale != 1.f) {
                x0 *= scale;
                x1 *= scale;
              }
              red_pair(dqb + (size_t)row * D, (c0 + c) * 16 + n * 8 + 2 * t, D,
                       x0, x1);
            }
        }
    }
  }
  cp_async_wait_all();

  // dk (scaled once) and dv, written once in k's type: no atomics.
  bf16* dkb = dk + (size_t)bkv * Sk * D;
  bf16* dvb = dv + (size_t)bkv * Sk * D;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + wrow + 16 * mt + g + 8 * i;
      if (key >= Sk) continue;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        float x0 = dk_acc[mt][n][2 * i], x1 = dk_acc[mt][n][2 * i + 1];
        if (scale != 1.f) {
          x0 *= scale;
          x1 *= scale;
        }
        store_pair(dkb + (size_t)key * D, n * 8 + 2 * t, D, x0, x1);
        store_pair(dvb + (size_t)key * D, n * 8 + 2 * t, D,
                   dv_acc[mt][n][2 * i], dv_acc[mt][n][2 * i + 1]);
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
  key_band<kBlockQ, kBlockK>(q0, Sq, Sk, causal, window, k_offset,
                             &kt_begin, &kt_end);

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

// Shared memory of K3a's tensor-core kernel: the q and do tiles, then two K
// and two V tiles (double buffer), every row DM + 8 bf16 wide.
template <int DM>
struct DqLayout {
  static constexpr int LD = DM + 8;
  static constexpr size_t bytes =
      (size_t)(2 * kMmaBlockQ + 4 * kMmaBlockK) * LD * sizeof(bf16);
};

// K3a in bf16: the dq sweep on the tensor cores, register-resident. One
// block per (b * h, 128-row q tile), MT m-tiles of 16 rows per warp; for
// each 16-key slice of a key tile a warp forms s = q.k^T and dp = do.v^T in
// registers (q's and do's A fragments stay in registers for the sweep),
// then ds = exp(s - lse) * (dp - di) from its rows' lse and di, rounds ds
// to bf16 as the A fragment of ds.k, and adds that product to its dq
// accumulator, which stays in registers for the whole sweep. Each K / V
// fragment read from shared memory feeds the warp's MT m-tiles.
template <int DM>
__global__ void __launch_bounds__(MmaShape<DM>::kThreads, DM <= 64 ? 2 : 1)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, bf16* __restrict__ dq,
                        int H, int Hkv, int Sq, int Sk, int D, int causal,
                        int window, int k_offset, float scale) {
  constexpr int LD = DqLayout<DM>::LD;
  constexpr int BK = kMmaBlockK;
  constexpr int MT = MmaShape<DM>::MT;
  constexpr int NT = MmaShape<DM>::kThreads;
  constexpr int KK = DM / 16;              // k-steps of q.k^T and do.v^T
  constexpr int NO = DM / 8;               // n-tiles of a dq row block
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + kMmaBlockQ * LD;
  bf16* sk = sdo + kMmaBlockQ * LD;        // [2][BK][LD]
  bf16* sv = sk + 2 * BK * LD;             // [2][BK][LD]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int bkv = b * Hkv + (bh - b * H) / (H / Hkv);
  const int nq = (Sq + kMmaBlockQ - 1) / kMmaBlockQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * kMmaBlockQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = warp * 16 * MT;
  const bool vec = D % 8 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(dout);

  const bf16* kb = k + (size_t)bkv * Sk * D;
  const bf16* vb = v + (size_t)bkv * Sk * D;

  int kt_begin, kt_end;
  key_band<kMmaBlockQ, BK>(q0, Sq, Sk, causal, window, k_offset, &kt_begin,
                           &kt_end);

  load_rows<DM, kMmaBlockQ, NT>(sq, q + (size_t)bh * Sq * D, q0, Sq, D, vec);
  load_rows<DM, kMmaBlockQ, NT>(sdo, dout + (size_t)bh * Sq * D, q0, Sq, D,
                                vec);
  if (kt_begin < kt_end) {
    load_rows<DM, BK, NT>(sk, kb, kt_begin * BK, Sk, D, vec);
    load_rows<DM, BK, NT>(sv, vb, kt_begin * BK, Sk, D, vec);
  }
  cp_async_commit();

  // The lse and di of each m-tile's rows g and g + 8 (0 past Sq: such rows
  // are computed and never written).
  float row_lse[MT][2], row_di[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + wrow + 16 * mt + g + 8 * i;
      row_lse[mt][i] = row < Sq ? lse[(size_t)bh * Sq + row] : 0.f;
      row_di[mt][i] = row < Sq ? di[(size_t)bh * Sq + row] : 0.f;
    }
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[MT][KK][4], dof[MT][KK][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const int off = a_offset<LD>(lane, wrow + 16 * mt, kk * 16);
      ldmatrix_x4(qf[mt][kk], sq + off);
      ldmatrix_x4(dof[mt][kk], sdo + off);
    }

  float acc[MT][NO][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  // exp(scale * s - lse) as one FMA and exp2 on the tiles that need no mask.
  const float s_log2 = scale * kLog2e;

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
    bool masked[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      masked[mt] = needs_mask<BK>(q0 + wrow + 16 * mt, k0, Sk, causal, window,
                                  k_offset);
    }

#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      // s and dp for keys k0 + 16j .. k0 + 16j + 15: two n-tiles each.
      float s[MT][2][4], dp[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][n][e] = dp[mt][n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        uint32_t bf[4];
        ldmatrix_x4(bf, skt + b_offset<LD>(lane, j * 16, kk * 16));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16816(s[mt][0], qf[mt][kk], bf[0], bf[1]);
          mma_16816(s[mt][1], qf[mt][kk], bf[2], bf[3]);
        }
        ldmatrix_x4(bf, svt + b_offset<LD>(lane, j * 16, kk * 16));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16816(dp[mt][0], dof[mt][kk], bf[0], bf[1]);
          mma_16816(dp[mt][1], dof[mt][kk], bf[2], bf[3]);
        }
      }

      // ds = p * (dp - di), p = exp(s - lse), rounded to bf16 as the A
      // fragment of ds.k.
      uint32_t da[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (masked[mt]) {
          const int r0 = q0 + wrow + 16 * mt;
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + j * 16 + n * 8 + 2 * t + (e & 1);
              const int qpos = r0 + g + (e >> 1) * 8;
              float ds = 0.f;
              if (key < Sk) {
                float x = scale != 1.f ? scale * s[mt][n][e] : s[mt][n][e];
                if (causal && !keeps(qpos, key + k_offset, window)) {
                  x = kNegInf;
                }
                ds = exp2_approx((x - row_lse[mt][e >> 1]) * kLog2e) *
                     (dp[mt][n][e] - row_di[mt][e >> 1]);
              }
              s[mt][n][e] = ds;
            }
        } else {
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[mt][n][e] =
                  exp2_approx(fmaf(s[mt][n][e], s_log2,
                                   -row_lse[mt][e >> 1] * kLog2e)) *
                  (dp[mt][n][e] - row_di[mt][e >> 1]);
            }
        }
        da[mt][0] = pack_bf16(s[mt][0][0], s[mt][0][1]);
        da[mt][1] = pack_bf16(s[mt][0][2], s[mt][0][3]);
        da[mt][2] = pack_bf16(s[mt][1][0], s[mt][1][1]);
        da[mt][3] = pack_bf16(s[mt][1][2], s[mt][1][3]);
      }

      // dq += ds.k.
#pragma unroll
      for (int p = 0; p < DM / 16; ++p) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, skt + bt_offset<LD>(lane, j * 16, p * 16));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16816(acc[mt][2 * p], da[mt], bf[0], bf[1]);
          mma_16816(acc[mt][2 * p + 1], da[mt], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait_all();

  // dq, scaled once, written once in q's type.
  bf16* dqb = dq + (size_t)bh * Sq * D;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + wrow + 16 * mt + g + 8 * i;
      if (row >= Sq) continue;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        float x0 = acc[mt][n][2 * i], x1 = acc[mt][n][2 * i + 1];
        if (scale != 1.f) {
          x0 *= scale;
          x1 *= scale;
        }
        store_pair(dqb + (size_t)row * D, n * 8 + 2 * t, D, x0, x1);
      }
    }
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
  const float* l = static_cast<const float*>(a.lse);
  const float* r = static_cast<const float*>(a.di);
  float* g = static_cast<float*>(a.dq);
  if (a.b16) {
    const dim3 grid(a.B * a.Hkv, (a.Sk + kKvBlockK - 1) / kKvBlockK);
    return launch(flash_bwd_kv_mma_kernel<DM, kDq>, KvLayout<DM, kDq>::bytes,
                  grid, KvShape<DM>::kThreads, a.stream,
                  static_cast<const bf16*>(a.q),
                  static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
                  static_cast<const bf16*>(a.dout), l, r, g,
                  static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H,
                  a.Hkv, a.Sq, a.Sk, a.D, a.causal, a.window, a.k_offset,
                  a.scale);
  }
  const dim3 grid(a.B * a.Hkv, (a.Sk + kBlockK - 1) / kBlockK);
  return launch(flash_bwd_f32_kernel<DM, kDq>,
                sizeof(float) * smem_floats<DM>(), grid, kThreads, a.stream,
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
  const float* l = static_cast<const float*>(a.lse);
  const float* r = static_cast<const float*>(a.di);
  if (a.b16) {
    const dim3 grid(a.B * a.H, (a.Sq + kMmaBlockQ - 1) / kMmaBlockQ);
    return launch(flash_bwd_dq_mma_kernel<DM>, DqLayout<DM>::bytes, grid,
                  MmaShape<DM>::kThreads, a.stream, static_cast<const bf16*>(a.q),
                  static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
                  static_cast<const bf16*>(a.dout), l, r,
                  static_cast<bf16*>(a.dq), a.H, a.Hkv, a.Sq, a.Sk, a.D,
                  a.causal, a.window, a.k_offset, a.scale);
  }
  constexpr size_t floats = 2 * (size_t)kBlockQ * DM +
                            2 * (size_t)kBlockK * (DM + 1) +
                            (size_t)kBlockQ * kPS + 2 * (size_t)kBlockQ;
  const dim3 grid(a.B * a.H, (a.Sq + kBlockQ - 1) / kBlockQ);
  return launch(flash_bwd_dq_f32_kernel<DM>, sizeof(float) * floats, grid,
                kThreads, a.stream, static_cast<const float*>(a.q),
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
