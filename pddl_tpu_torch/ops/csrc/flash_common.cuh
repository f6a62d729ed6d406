// Device helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the mask constant and band arithmetic, the launch helper,
// and the pieces of the register-resident tensor-core design that K1 and
// K3a are built from — cp.async 16-byte tile copies into padded shared
// rows, ldmatrix fragment loads and the mma.sync m16n8k16 bf16 product.
//
// Fragment layouts of mma.sync.m16n8k16 (bf16 in, f32 accumulate), for lane
// l of a warp, g = l / 4 and t = l % 4:
//   A (16 x 16, row-major), 4 x b32: a0 (row g, cols 2t, 2t+1),
//     a1 (row g+8, the same cols), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8);
//   B (16 x 8, k x n), 2 x b32: b0 (k 2t, 2t+1; n g), b1 (k 2t+8, 2t+9; n g);
//   C (16 x 8), 4 x f32: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// Two adjacent C tiles (keys 16j .. 16j+15 of one row block), rounded to
// bf16 and packed in pairs, are exactly the A fragment of a product over
// those 16 keys: that is how p (K1) and ds (K3a) feed the next product from
// registers, with no trip through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace pddl_flash {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;         // a masked score
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;             // the WMMA and f32 kernels' blocks
constexpr size_t kMaxSmem = 232448;       // an H100 block's dynamic shared memory

// The mma.sync kernels (K1, K3a): 128 query rows per block against 64-key
// tiles. A warp owns MT m-tiles of 16 rows: two where registers allow
// (DM <= 64), so that every K / V fragment read from shared memory feeds
// two products; one at DM 128.
constexpr int kMmaBlockQ = 128;
constexpr int kMmaBlockK = 64;

template <int DM>
struct MmaShape {
  static constexpr int MT = DM <= 64 ? 2 : 1;
  static constexpr int kWarps = kMmaBlockQ / (16 * MT);
  static constexpr int kThreads = 32 * kWarps;
};

__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// The key tiles (BK keys each) that some row of the BQ-row q tile at q0
// sees: the forward's band (the JAX package's _block_in_band arithmetic),
// [*kt_begin, *kt_end).
template <int BQ, int BK>
__device__ __forceinline__ void key_band(int q0, int Sq, int Sk, int causal,
                                         int window, int k_offset,
                                         int* kt_begin, int* kt_end) {
  *kt_begin = 0;
  *kt_end = (Sk + BK - 1) / BK;
  if (causal) {
    const int q_last = min(q0 + BQ - 1, Sq - 1);
    *kt_end = min(*kt_end, max(0, floor_div(q_last - k_offset, BK) + 1));
    if (window > 0) {
      *kt_begin = max(0, floor_div(q0 - window + 1 - k_offset, BK));
    }
  }
}

// Whether rows [r0, r0 + 16) against keys [k0, k0 + BK) need the mask: a
// key past Sk, or (causal) a key after a row or outside a row's window.
template <int BK>
__device__ __forceinline__ bool needs_mask(int r0, int k0, int Sk, int causal,
                                           int window, int k_offset) {
  if (k0 + BK > Sk) return true;
  if (!causal) return false;
  if (k0 + BK - 1 + k_offset > r0) return true;
  return window > 0 && k0 + k_offset <= r0 + 15 - window;
}

// Whether query qpos keeps key position kpos = key + k_offset.
__device__ __forceinline__ bool keeps(int qpos, int kpos, int window) {
  return qpos >= kpos && (window <= 0 || kpos > qpos - window);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src
// must still be a valid address; nothing is read from it).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 2^x on the special-function unit (flushes results below 2^-126 to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 b16 matrices; lane l supplies the address of row l % 8 of
// matrix l / 8 and receives, in r[i], row l / 4 of matrix i, elements
// 2(l % 4) and 2(l % 4) + 1 (.trans: of the transposed matrix).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a.b on the tensor cores (m16n8k16, bf16 in, f32 accumulate).
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 (to nearest even) in one b32, lo first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ldmatrix offsets (in elements, rows of stride LD) for lane l:
//  - an A fragment, rows 16 x cols 16 at (r0, c0): row r0 + l % 16, col
//    c0 + 8 (l / 16);
//  - B fragments of two n-tiles from a [n][k] tile (non-trans; K for q.k^T,
//    V for do.v^T): row n0 + 8 (l / 16) + l % 8, col k0 + 8 ((l / 8) % 2),
//    giving {b0, b1} of n-tile n0 and {b0, b1} of n-tile n0 + 8;
//  - B fragments of two n-tiles from a [k][n] tile (.trans; V for p.v, K
//    for ds.k): row k0 + l % 16, col n0 + 8 (l / 16), the same order.
template <int LD>
__device__ __forceinline__ int a_offset(int lane, int r0, int c0) {
  return (r0 + (lane & 15)) * LD + c0 + ((lane >> 4) << 3);
}

template <int LD>
__device__ __forceinline__ int b_offset(int lane, int n0, int k0) {
  return (n0 + ((lane >> 4) << 3) + (lane & 7)) * LD + k0 +
         (((lane >> 3) & 1) << 3);
}

template <int LD>
__device__ __forceinline__ int bt_offset(int lane, int k0, int n0) {
  return (k0 + (lane & 15)) * LD + n0 + ((lane >> 4) << 3);
}

// Stage rows [row0, row0 + ROWS) of a [rows, D] bf16 array into a
// [ROWS][DM + 8] shared tile (the 16-byte pad per row keeps ldmatrix free of
// bank conflicts), zero-filled past `rows` and past D, with all THREADS
// threads of the block. `vec` (D a multiple of 8, the array 16-byte
// aligned): asynchronous 16-byte cp.async copies, one commit group per
// caller; otherwise one value at a time, synchronously.
template <int DM, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int rows, int D,
                                          bool vec) {
  constexpr int LD = DM + 8;
  if (vec) {
    constexpr int kChunks = DM / 8;
    for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
      const int r = i / kChunks;
      const int c = (i - r * kChunks) * 8;
      const bool ok = row0 + r < rows && c < D;
      cp_async_16(dst + r * LD + c,
                  ok ? src + (size_t)(row0 + r) * D + c : src, ok);
    }
    return;
  }
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < ROWS * DM; i += THREADS) {
    const int r = i / DM;
    const int d = i - r * DM;
    const int row = row0 + r;
    dst[r * LD + d] = (row < rows && d < D) ? src[(size_t)row * D + d] : zero;
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Store a thread's two adjacent f32 values of row `row` at columns col,
// col + 1 (col even) in bf16, within [0, D).
__device__ __forceinline__ void store_pair(bf16* row, int col, int D, float x0,
                                           float x1) {
  if ((D & 1) == 0) {
    if (col < D) {
      *reinterpret_cast<__nv_bfloat162*>(row + col) =
          __floats2bfloat162_rn(x0, x1);
    }
    return;
  }
  if (col < D) row[col] = __float2bfloat16(x0);
  if (col + 1 < D) row[col + 1] = __float2bfloat16(x1);
}

// Launch a kernel of `threads` threads with `smem` bytes of dynamic shared
// memory (raising the per-block limit above 48 KiB where it needs more).
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, int threads,
                   cudaStream_t stream, Args... args) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace pddl_flash
