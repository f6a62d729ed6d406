// Paged decode attention for Hopper (sm_90a): one query token per row
// attends its KV prefix through a per-row block table into a shared pool.
//
// Replaces the Pallas kernel pddl_tpu/ops/attention.py:_paged_decode_kernel
// (launched by paged_decode_attention_kernel). It computes the same
// function: q [B, H, 1, D]; pools [N, Hkv, bs, D] (f32 or bf16); table
// [B, T] int32; index [B] int32. Row b attends pool positions
// j*bs + o <= index[b] through table[b, j] (and > index[b] - window when a
// window is given), with a softmax in f32: NEG_INF = -1e30 for masked
// scores, p rounded to the pool's type before the P.V product (the
// reference casts p to v's dtype), the denominator summing p unrounded, and
// a 1e-30 floor on it. Output [B, H, 1, D] in q's type. A table entry
// outside [0, N) reads the scratch block 0 instead (the pool's write-sink
// contract), so a bad table can produce junk but never an out-of-bounds
// read.
//
// What bounds it on an H100: bytes. A live token costs 2 * D * itemsize
// bytes of K and V per kv head and 4 * rep * D flops (about one flop per
// byte at rep 4 in bf16, against the ~295 the card needs before its tensor
// cores become the limit), so the design's job is to keep many loads in
// flight along a short chain of dependent latencies, not tensor cores.
// The TPU kernel swept the table in order (its grid runs in order); here
// the sweep is split across blocks and merged afterwards (flash-decoding):
//
//  - grid (B * Hkv * chunks, S): one block per (row, kv head, chunk of at
//    most 8 of the group's rep query heads) and split s of S. Split s takes
//    the table entries [s * per_split, (s + 1) * per_split). The wrapper
//    chooses S and per_split from the shapes and the SM count alone, never
//    from index, so the launch geometry is the same every decode tick. A
//    split whose entries lie past the row's depth, or wholly before its
//    window, writes an empty partial (m = -1e30, l = 0) and exits;
//  - K and V are read as 16-byte vectors (8 bf16 or 4 f32), neighbouring
//    lanes on neighbouring addresses: LPT lanes cover one token's row, so
//    a warp covers 32 / LPT consecutive tokens in one load (4 at D 64
//    bf16). Each lane issues the loads of up to kPF tokens before any of
//    their math, and the data stays in the pool's type until it reaches
//    registers. (Scalar loads where D * itemsize is not a multiple of 16
//    or a pointer is not 16-byte aligned.);
//  - the query rows, each token slot's running max, denominator and
//    accumulator live in registers. Dot products reduce across a token's
//    LPT lanes by xor shuffles; the slots of a warp merge by shuffles, the
//    4 warps through shared memory behind the block's only barrier;
//  - with S > 1 each split writes (m, l, acc) in f32 to a scratch buffer
//    the wrapper allocated, and a second small kernel (one thread per
//    output element) merges the splits in order: out = sum e^(m_s - M)
//    acc_s / max(sum e^(m_s - M) l_s, 1e-30). With S = 1 the block writes
//    the output itself. Every sum runs in a fixed order, so two runs are
//    bitwise equal.
//
// Any D <= 256, bs <= 64, and rep = H / Hkv of any size.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHeadDim = 256;
constexpr int kMaxBlockSize = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One load's worth of a row: 16 bytes (kWide) or one element.
template <typename T, bool kWide>
struct Pack;

template <typename T>
struct Pack<T, true> {
  static constexpr int N = 16 / sizeof(T);
  using Raw = uint4;
  __device__ static Raw load(const T* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static void unpack(const Raw& r, float* f);
};

template <>
__device__ __forceinline__ void Pack<float, true>::unpack(const uint4& r,
                                                          float* f) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

template <>
__device__ __forceinline__ void Pack<__nv_bfloat16, true>::unpack(
    const uint4& r, float* f) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // bf16 -> f32 is a 16-bit shift: low half first in memory.
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T>
struct Pack<T, false> {
  static constexpr int N = 1;
  using Raw = T;
  __device__ static Raw load(const T* p) { return *p; }
  __device__ static Raw zero() { return from_f32<T>(0.f); }
  __device__ static void unpack(const Raw& r, float* f) { f[0] = to_f32(r); }
};

// Tokens a lane loads before any of their math: as many as fit a budget of
// ~64 registers of raw K/V (half that with 8 query heads in registers).
template <typename Raw, int VPL, int RC>
__host__ __device__ constexpr int prefetch_depth() {
  constexpr int regs = 2 * VPL * (int)sizeof(Raw) / 4;
  constexpr int budget = RC > 4 ? 32 : 64;
  return budget / regs > 0 ? budget / regs : 1;
}

// T: element type; kWide: 16-byte loads; VPL: loads per lane per row;
// RC: query heads a block serves (a chunk of the group's rep); LPT: lanes
// that hold one token's row (a power of two; lanes past the row idle).
template <typename T, bool kWide, int VPL, int RC, int LPT>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q,
                          const T* __restrict__ k_pool,
                          const T* __restrict__ v_pool,
                          const int* __restrict__ table,
                          const int* __restrict__ index,
                          T* __restrict__ out, float* __restrict__ part_acc,
                          float* __restrict__ part_ml, int H, int Hkv, int N,
                          int bs, int D, int T_, int window, float scale,
                          int per_split) {
  using P = Pack<T, kWide>;
  using Raw = typename P::Raw;
  constexpr int kVec = P::N;
  constexpr int kEl = VPL * kVec;  // elements of a row a lane holds
  constexpr int kPF = prefetch_depth<Raw, VPL, RC>();
  __shared__ float s_acc[kWarps][RC][kMaxHeadDim];
  __shared__ float s_m[kWarps][RC];
  __shared__ float s_l[kWarps][RC];

  const int rep = H / Hkv;
  const int n_chunk = (rep + RC - 1) / RC;
  const int bg = blockIdx.x / n_chunk;
  const int chunk = blockIdx.x - bg * n_chunk;
  const int b = bg / Hkv;
  const int g = bg - b * Hkv;
  const int h0 = g * rep + chunk * RC;  // first query head of this block
  const int nr = min(RC, rep - chunk * RC);
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (LPT - 1);   // which vectors of the row
  constexpr int tpw = 32 / LPT;       // tokens a warp loads at once
  constexpr int nslot = tpw * kWarps;  // tokens the block loads at once
  const int wslot = warp * tpw;       // the warp's first token slot
  const int nv = D / kVec;            // vectors per row

  // The split's live positions: its entries, cut to [depth - window + 1,
  // depth]. Uniform over the block.
  const int depth = __ldg(index + b);
  int lo = split * per_split * bs;
  int hi = min(T_, (split + 1) * per_split) * bs;
  hi = min(hi, depth + 1);
  if (window > 0) lo = max(lo, depth - window + 1);
  const size_t part = ((size_t)b * H + h0) * n_split + split;

  if (lo >= hi && n_split > 1) {  // an empty partial
    for (int i = threadIdx.x; i < nr * D; i += kThreads) {
      const int r = i / D;
      part_acc[(part + (size_t)r * n_split) * D + (i - r * D)] = 0.f;
    }
    for (int r = threadIdx.x; r < nr; r += kThreads) {
      part_ml[2 * (part + (size_t)r * n_split)] = kNegInf;
      part_ml[2 * (part + (size_t)r * n_split) + 1] = 0.f;
    }
    return;
  }

  float qf[RC][kEl];
#pragma unroll
  for (int r = 0; r < RC; ++r) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int vi = sub + i * LPT;
      Raw raw = P::zero();
      if (r < nr && vi < nv) {
        raw = P::load(q + ((size_t)b * H + h0 + r) * D + vi * kVec);
      }
      P::unpack(raw, &qf[r][i * kVec]);
    }
  }
  float m[RC], l[RC], acc[RC][kEl];
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kEl; ++e) acc[r][e] = 0.f;
  }

  // Token slot (wslot + lane / LPT) takes positions lo + slot, + nslot, ...
  // The loop bound is the warp's, so every lane joins every shuffle.
  const int my = lane / LPT;
  for (int base = lo + wslot; base < hi; base += kPF * nslot) {
    Raw kr[kPF][VPL], vr[kPF][VPL];
    bool ok[kPF];
#pragma unroll
    for (int t = 0; t < kPF; ++t) {
      const int pos = base + my + t * nslot;
      ok[t] = pos < hi;
      size_t row = 0;
      if (ok[t]) {
        const int j = pos / bs;
        int blk = __ldg(table + (size_t)b * T_ + j);
        if (blk < 0 || blk >= N) blk = 0;
        row = (((size_t)blk * Hkv + g) * bs + (pos - j * bs)) * D;
      }
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int vi = sub + i * LPT;
        kr[t][i] = P::zero();
        vr[t][i] = P::zero();
        if (ok[t] && vi < nv) {
          kr[t][i] = P::load(k_pool + row + vi * kVec);
          vr[t][i] = P::load(v_pool + row + vi * kVec);
        }
      }
    }

    float s[kPF][RC];
#pragma unroll
    for (int t = 0; t < kPF; ++t) {
      float kf[kEl];
#pragma unroll
      for (int i = 0; i < VPL; ++i) P::unpack(kr[t][i], &kf[i * kVec]);
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kEl; ++e) dot = fmaf(qf[r][e], kf[e], dot);
#pragma unroll
        for (int off = LPT >> 1; off > 0; off >>= 1) {
          dot += __shfl_xor_sync(kFull, dot, off);
        }
        s[t][r] = dot * scale;
      }
    }

    // Online softmax over this batch of tokens, one rescale per batch.
    // p[t][r] rounded to the pool's type for the P.V product.
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      float mx = m[r];
#pragma unroll
      for (int t = 0; t < kPF; ++t) {
        if (ok[t]) mx = fmaxf(mx, s[t][r]);
      }
      const float alpha = expf(m[r] - mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kPF; ++t) {
        const float p = ok[t] ? expf(s[t][r] - mx) : 0.f;
        sum += p;
        s[t][r] = to_f32(from_f32<T>(p));
      }
      l[r] = l[r] * alpha + sum;
      m[r] = mx;
#pragma unroll
      for (int e = 0; e < kEl; ++e) acc[r][e] *= alpha;
    }
#pragma unroll
    for (int t = 0; t < kPF; ++t) {
      float vf[kEl];
#pragma unroll
      for (int i = 0; i < VPL; ++i) P::unpack(vr[t][i], &vf[i * kVec]);
#pragma unroll
      for (int r = 0; r < RC; ++r) {
#pragma unroll
        for (int e = 0; e < kEl; ++e) acc[r][e] = fmaf(s[t][r], vf[e], acc[r][e]);
      }
    }
  }

  // Merge the warp's token slots (lanes LPT apart) by xor shuffles: every
  // lane ends with the same sums, in the same order on every run.
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    float mx = m[r];
#pragma unroll
    for (int off = LPT; off < 32; off <<= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    }
    const float w = expf(m[r] - mx);
    float lw = l[r] * w;
#pragma unroll
    for (int off = LPT; off < 32; off <<= 1) {
      lw += __shfl_xor_sync(kFull, lw, off);
    }
#pragma unroll
    for (int e = 0; e < kEl; ++e) {
      float a = acc[r][e] * w;
  #pragma unroll
    for (int off = LPT; off < 32; off <<= 1) {
        a += __shfl_xor_sync(kFull, a, off);
      }
      acc[r][e] = a;
    }
    m[r] = mx;
    l[r] = lw;
  }
  if (lane < LPT) {
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      if (sub == 0) {
        s_m[warp][r] = m[r];
        s_l[warp][r] = l[r];
      }
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int vi = sub + i * LPT;
        if (vi < nv) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            s_acc[warp][r][vi * kVec + e] = acc[r][i * kVec + e];
          }
        }
      }
    }
  }
  __syncthreads();

  // Merge the 4 warps in order; write the output (S = 1) or the partial.
  for (int i = threadIdx.x; i < nr * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(s_m[w][r] - mx);
      den += s_l[w][r] * wt;
      num += s_acc[w][r][d] * wt;
    }
    if (n_split == 1) {
      out[((size_t)b * H + h0 + r) * D + d] =
          from_f32<T>(num / fmaxf(den, 1e-30f));
    } else {
      const size_t pr = part + (size_t)r * n_split;
      part_acc[pr * D + d] = num;
      if (d == 0) {
        part_ml[2 * pr] = mx;
        part_ml[2 * pr + 1] = den;
      }
    }
  }
}

// out[bh, d] = sum_s e^(m_s - M) acc_s[d] / max(sum_s e^(m_s - M) l_s,
// 1e-30), the splits taken in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_merge_kernel(const float* __restrict__ part_acc,
                          const float* __restrict__ part_ml,
                          T* __restrict__ out, int BH, int n_split, int D) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= BH * D) return;
  const int bh = i / D;
  const int d = i - bh * D;
  const float* ml = part_ml + 2 * (size_t)bh * n_split;
  float mx = kNegInf;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ml[2 * s]);
  float num = 0.f, den = 0.f;
  const float* acc = part_acc + (size_t)bh * n_split * D + d;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(ml[2 * s] - mx);
    den += ml[2 * s + 1] * w;
    num += acc[(size_t)s * D] * w;
  }
  out[i] = from_f32<T>(num / fmaxf(den, 1e-30f));
}

struct Args {
  const void *q, *k_pool, *v_pool, *table, *index;
  void *out, *scratch;
  int B, H, Hkv, N, bs, D, T_, window;
  float scale;
  int n_split, per_split;
};

template <typename T, bool kWide, int VPL, int RC, int LPT>
cudaError_t launch_split(const Args& a, cudaStream_t stream) {
  const int rep = a.H / a.Hkv;
  const dim3 grid(a.B * a.Hkv * ((rep + RC - 1) / RC), a.n_split);
  float* part_acc = static_cast<float*>(a.scratch);
  float* part_ml =
      part_acc ? part_acc + (size_t)a.B * a.H * a.n_split * a.D : nullptr;
  paged_decode_split_kernel<T, kWide, VPL, RC, LPT>
      <<<grid, kThreads, 0, stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
          static_cast<const T*>(a.v_pool), static_cast<const int*>(a.table),
          static_cast<const int*>(a.index), static_cast<T*>(a.out), part_acc,
          part_ml, a.H, a.Hkv, a.N, a.bs, a.D, a.T_, a.window, a.scale,
          a.per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return e;
  const int bhd = a.B * a.H * a.D;
  paged_decode_merge_kernel<T><<<(bhd + kThreads - 1) / kThreads, kThreads, 0,
                                 stream>>>(part_acc, part_ml,
                                           static_cast<T*>(a.out), a.B * a.H,
                                           a.n_split, a.D);
  return cudaGetLastError();
}

template <typename T, bool kWide, int VPL, int LPT>
cudaError_t launch_rc(const Args& a, cudaStream_t stream) {
  const int rep = a.H / a.Hkv;
  if (rep == 1) return launch_split<T, kWide, VPL, 1, LPT>(a, stream);
  if (rep == 2) return launch_split<T, kWide, VPL, 2, LPT>(a, stream);
  if (rep <= 4) return launch_split<T, kWide, VPL, 4, LPT>(a, stream);
  return launch_split<T, kWide, VPL, 8, LPT>(a, stream);
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const bool aligned =
      (reinterpret_cast<size_t>(a.q) | reinterpret_cast<size_t>(a.k_pool) |
       reinterpret_cast<size_t>(a.v_pool)) % 16 == 0;
  if (aligned && (a.D * sizeof(T)) % 16 == 0) {
    const int nv = a.D * (int)sizeof(T) / 16;  // 16-byte vectors per row
    if (nv <= 4) return launch_rc<T, true, 1, 4>(a, stream);
    if (nv <= 8) return launch_rc<T, true, 1, 8>(a, stream);
    if (nv <= 16) return launch_rc<T, true, 1, 16>(a, stream);
    if (nv <= 32) return launch_rc<T, true, 1, 32>(a, stream);
    if constexpr (sizeof(T) == 4) {  // f32 rows of up to 64 vectors
      return launch_rc<T, true, 2, 32>(a, stream);
    }
    return cudaErrorInvalidValue;
  }
  // Scalar loads: one element per load, up to 8 per lane (D <= 256).
  return launch_split<T, false, 8, 8, 32>(a, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window. The grid
// is (B * Hkv * ceil(rep / 8), n_split); split s covers table entries
// [s * per_split, (s + 1) * per_split). With n_split > 1, scratch holds
// B * H * n_split * (D + 2) floats; with n_split == 1 it may be NULL.
// Returns 0 on launched kernels, else the cudaError_t of the refusal.
int pddl_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                      const void* table, const void* index, void* out,
                      void* scratch, int B, int H, int Hkv, int N, int bs,
                      int D, int T_, int window, float scale, int n_split,
                      int per_split, int dtype, void* stream) {
  if (B < 1 || Hkv < 1 || H % Hkv != 0 || N < 1 || T_ < 1 || bs < 1 ||
      bs > kMaxBlockSize || D < 1 || D > kMaxHeadDim || n_split < 1 ||
      per_split < 1 || (long long)n_split * per_split < T_ ||
      (long long)(n_split - 1) * per_split >= T_ ||
      (n_split > 1 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q,  k_pool, v_pool, table, index, out,    scratch,
               B,  H,      Hkv,    N,     bs,    D,      T_,
               window, scale, n_split, per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

const char* pddl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
