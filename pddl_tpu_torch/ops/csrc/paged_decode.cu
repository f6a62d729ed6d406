// Paged decode attention for Hopper (sm_90a): one query token per row
// attends its KV prefix through a per-row block table into a shared pool.
//
// Replaces the Pallas kernel pddl_tpu/ops/attention.py:_paged_decode_kernel
// (launched by paged_decode_attention_kernel). It computes the same
// function: q [B, H, 1, D]; pools [N, Hkv, bs, D] (f32 or bf16); table
// [B, T] int32; index [B] int32. Row b attends pool positions
// j*bs + o <= index[b] through table[b, j] (and > index[b] - window when a
// window is given), with an online softmax in f32: NEG_INF = -1e30 for
// masked scores, p rounded to the pool's type before the P.V product (the
// reference casts p to v's dtype), and a 1e-30 floor on the denominator.
// Output [B, H, 1, D] in q's type.
//
// What bounds it on an H100: the bytes of K and V it must read for each
// row's live prefix (2 * Hkv * D * itemsize per live token, ~3.35 TB/s of
// HBM); its arithmetic (4 * H * D flops per live token) is far below the
// card's rate. The design is the simple one:
//  - one thread block per (row, kv head) serves the rep = H / Hkv query
//    heads of its group against UNEXPANDED K/V, so each K/V tile is read
//    from device memory once per group, not once per query head;
//  - a loop over table entries j < min(T, index[b] / bs + 1) takes the
//    place of the TPU's sequential grid and its skip of dead blocks (a
//    window raises the loop's start), so a row costs what its depth costs;
//  - the block reads table[b, j] itself (no scalar prefetch), stages the
//    [bs, D] K and V tiles in shared memory as f32 (K rows padded by one
//    so the per-thread score dot products hit distinct banks), keeps the
//    running max / denominator / accumulator in shared memory, and writes
//    the output once.
// Any D <= 256 and bs <= 64. A table entry outside [0, N) reads the
// scratch block 0 instead (the pool's write-sink contract), so a bad table
// can produce junk but never an out-of-bounds read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kMaxHeadDim = 256;
constexpr int kMaxBlockSize = 64;
constexpr size_t kMaxSmem = 232448;  // an H100 block's dynamic shared memory

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ table,
                    const int* __restrict__ index, T* __restrict__ out,
                    int H, int Hkv, int N, int bs, int D, int T_,
                    int window, float scale) {
  extern __shared__ float smem[];
  const int rep = H / Hkv;
  const int b = blockIdx.x / Hkv;
  const int g = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int ks = D + 1;           // padded K row stride
  float* sk = smem;               // [bs][D + 1]
  float* sv = sk + bs * ks;       // [bs][D]
  float* sq = sv + bs * D;        // [rep][D]
  float* sacc = sq + rep * D;     // [rep][D]
  float* sp = sacc + rep * D;     // [rep][bs] scores, then p
  float* sm = sp + rep * bs;      // [rep] running max
  float* sl = sm + rep;           // [rep] running denominator
  float* salpha = sl + rep;       // [rep] this step's rescale

  const int depth = index[b];
  const T* qg = q + ((size_t)b * H + (size_t)g * rep) * D;
  for (int i = tid; i < rep * D; i += blockDim.x) {
    sq[i] = to_f32(qg[i]);
    sacc[i] = 0.f;
  }
  for (int r = tid; r < rep; r += blockDim.x) {
    sm[r] = kNegInf;
    sl[r] = 0.f;
  }
  int j_end = depth / bs + 1;
  if (j_end > T_) j_end = T_;
  int j_begin = 0;
  if (window > 0 && depth - window + 1 > 0) j_begin = (depth - window + 1) / bs;
  __syncthreads();

  for (int j = j_begin; j < j_end; ++j) {
    int blk = table[(size_t)b * T_ + j];
    if (blk < 0 || blk >= N) blk = 0;
    const size_t base = ((size_t)blk * Hkv + g) * (size_t)bs * D;
    const T* kb = k_pool + base;
    const T* vb = v_pool + base;
    for (int i = tid; i < bs * D; i += blockDim.x) {
      const int o = i / D;
      sk[o * ks + (i - o * D)] = to_f32(kb[i]);
      sv[i] = to_f32(vb[i]);
    }
    __syncthreads();

    // Scores of the rep query heads against this block's bs keys.
    for (int i = tid; i < rep * bs; i += blockDim.x) {
      const int r = i / bs;
      const int o = i - r * bs;
      const int pos = j * bs + o;
      float s = kNegInf;
      if (pos <= depth && (window <= 0 || pos > depth - window)) {
        const float* qr = sq + r * D;
        const float* kr = sk + o * ks;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      sp[i] = s;
    }
    __syncthreads();

    // Online-softmax update, one thread per query head. The denominator
    // sums p in f32; the P.V product takes p rounded to the pool's type.
    for (int r = tid; r < rep; r += blockDim.x) {
      float* pr = sp + r * bs;
      const float m_prev = sm[r];
      float m_new = m_prev;
      for (int o = 0; o < bs; ++o) m_new = fmaxf(m_new, pr[o]);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int o = 0; o < bs; ++o) {
        const float p = expf(pr[o] - m_new);
        sum += p;
        pr[o] = to_f32(from_f32<T>(p));
      }
      sl[r] = sl[r] * alpha + sum;
      sm[r] = m_new;
      salpha[r] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < rep * D; i += blockDim.x) {
      const int r = i / D;
      const int d = i - r * D;
      const float* pr = sp + r * bs;
      float acc = sacc[i] * salpha[r];
      for (int o = 0; o < bs; ++o) acc = fmaf(pr[o], sv[o * D + d], acc);
      sacc[i] = acc;
    }
    __syncthreads();
  }

  T* og = out + ((size_t)b * H + (size_t)g * rep) * D;
  for (int i = tid; i < rep * D; i += blockDim.x) {
    og[i] = from_f32<T>(sacc[i] / fmaxf(sl[i / D], 1e-30f));
  }
}

size_t smem_bytes(int rep, int bs, int D) {
  return sizeof(float) * ((size_t)bs * (D + 1) + (size_t)bs * D +
                          2 * (size_t)rep * D + (size_t)rep * bs +
                          3 * (size_t)rep);
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* table, const void* index, void* out, int B,
                   int H, int Hkv, int N, int bs, int D, int T_, int window,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / Hkv, bs, D);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  paged_decode_kernel<T><<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(index), static_cast<T*>(out), H, Hkv, N, bs,
      D, T_, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window.
// Returns 0 on a launched kernel, else the cudaError_t of the refusal.
int pddl_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                      const void* table, const void* index, void* out, int B,
                      int H, int Hkv, int N, int bs, int D, int T_,
                      int window, float scale, int dtype, void* stream) {
  if (B < 1 || Hkv < 1 || H % Hkv != 0 || N < 1 || T_ < 1 || bs < 1 ||
      bs > kMaxBlockSize || D < 1 || D > kMaxHeadDim) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch<float>(q, k_pool, v_pool, table, index, out, B, H,
                              Hkv, N, bs, D, T_, window, scale, s);
  }
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16>(q, k_pool, v_pool, table, index, out,
                                      B, H, Hkv, N, bs, D, T_, window, scale,
                                      s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* pddl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
