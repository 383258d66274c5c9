// Y = X @ W with each column's sum(Y) and sum(Y^2) taken in the epilogue,
// for Hopper (sm_90a): bf16 operands, f32 accumulation.
//
// Replaces the Pallas kernel `_mm_stats_kernel` driven by `_matmul_stats_fwd`
// and `matmul_stats` in distributeddeeplearningspark_tpu/ops/conv_bn.py (the
// fused 1x1-conv + BatchNorm-statistics matmul of the ResNet bottlenecks). It
// computes what that kernel computes, not its block structure:
//
//   - one thread block of 4 warps per 128 x 64 tile of Y; warp w owns rows
//     [32w, 32w + 32) of the tile and all 64 columns. The loop over 32-deep
//     K slices inside the block takes the place of the TPU grid's sequential
//     ("arbitrary") K axis and its VMEM accumulator.
//   - the product runs on the tensor cores through mma.sync m16n8k16 (bf16
//     operands from shared memory by ldmatrix, f32 accumulators in
//     registers).
//   - the epilogue writes Y rounded to bf16 (round to nearest even) and, from
//     the f32 accumulators, not from the rounded Y, reduces each column of
//     the tile: warp shuffles over the warp's rows, then shared memory over
//     the 4 warps in a fixed order. One partial sum and sum of squares per
//     (row tile, column) goes to [num_row_tiles, N] f32 scratch; the wrapper
//     sums it over the row tiles. No atomics: the result is deterministic.
//   - rows past M and columns past N (ragged edges) are zero-filled in shared
//     memory, so they add nothing to the sums, and are never written. Shapes
//     with K and N multiples of 8 load 16 bytes a thread; others (any K, N)
//     take an element-wise load path.
//   - the TPU kernel's [nm, 8, N] replicated-sublane layout of the partial
//     sums is a Mosaic block-rule workaround and is not carried over.
//
// Bound on the card: at ResNet-50's shapes (M = 256*56*56 = 802816 rows down
// to 50176, K and N 64..1024) the kernel must read X and W and write Y, and
// does 2*M*K*N operations: 32 to 339 operations per byte, against the 295 at
// which 989 TFLOP/s and 3.35 TB/s meet, so the bytes bound 9 of the 10
// shapes and the operations the last, (50176, 1024, 512). This first
// version loads each slice synchronously into shared memory (no
// cp.async/TMA pipeline, no wgmma); it is correct and simple, and faster
// versions are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 128;              // rows of Y per thread block
constexpr int kBlockN = 64;               // columns of Y per thread block
constexpr int kBlockK = 32;               // depth of one K slice
constexpr int kThreads = 128;             // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kWarpM = kBlockM / kWarps;  // 32 rows per warp
constexpr int kMTiles = kWarpM / 16;      // m16 tiles per warp
constexpr int kNTiles = kBlockN / 8;      // n8 tiles per warp
constexpr int kLdA = kBlockK + 8;         // padded smem rows (16-byte aligned)
constexpr int kLdB = kBlockN + 8;

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each matrix transposed: the B operand from a [k][n] tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Copy X[m0:m0+128, k0:k0+32] and W[k0:k0+32, n0:n0+64] into shared memory,
// zero outside [M, K] and [K, N]. kVec: K and N are multiples of 8 and the
// operands 16-byte aligned, so each thread moves 16 bytes at a time.
template <bool kVec>
__device__ __forceinline__ void load_slice(__nv_bfloat16* sA, __nv_bfloat16* sB,
                                           const __nv_bfloat16* __restrict__ x,
                                           const __nv_bfloat16* __restrict__ w,
                                           int m0, int n0, int k0, int M, int K,
                                           int N) {
  if (kVec) {
    constexpr int kChunksA = kBlockK / 8;
    for (int i = threadIdx.x; i < kBlockM * kChunksA; i += kThreads) {
      const int r = i / kChunksA, c = (i % kChunksA) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M && k0 + c < K)
        v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(sA + r * kLdA + c) = v;
    }
    constexpr int kChunksB = kBlockN / 8;
    for (int i = threadIdx.x; i < kBlockK * kChunksB; i += kThreads) {
      const int r = i / kChunksB, c = (i % kChunksB) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < K && n0 + c < N)
        v = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * N + n0 + c);
      *reinterpret_cast<uint4*>(sB + r * kLdB + c) = v;
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < kBlockM * kBlockK; i += kThreads) {
      const int r = i / kBlockK, c = i % kBlockK;
      sA[r * kLdA + c] = (m0 + r < M && k0 + c < K)
                             ? x[(size_t)(m0 + r) * K + k0 + c] : zero;
    }
    for (int i = threadIdx.x; i < kBlockK * kBlockN; i += kThreads) {
      const int r = i / kBlockN, c = i % kBlockN;
      sB[r * kLdB + c] = (k0 + r < K && n0 + c < N)
                             ? w[(size_t)(k0 + r) * N + n0 + c] : zero;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store_pair(__nv_bfloat16* __restrict__ y, int r,
                                           int c, float v0, float v1, int M,
                                           int N) {
  if (r >= M) return;
  __nv_bfloat16* p = y + (size_t)r * N + c;
  if (kVec) {  // N % 8 == 0 and c even: c < N means c + 1 < N, 4-byte aligned
    if (c < N) *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (c < N) p[0] = __float2bfloat16_rn(v0);
    if (c + 1 < N) p[1] = __float2bfloat16_rn(v1);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
matmul_stats_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ ps1,
                    float* __restrict__ ps2, int M, int K, int N,
                    int n_col_tiles) {
  __shared__ __align__(16) __nv_bfloat16 sA[kBlockM * kLdA];
  __shared__ __align__(16) __nv_bfloat16 sB[kBlockK * kLdB];
  __shared__ float sRed[2][kWarps][kBlockN];

  // column tiles vary fastest, so blocks that run together share X's rows
  const int row_tile = blockIdx.x / n_col_tiles;
  const int m0 = row_tile * kBlockM;
  const int n0 = (blockIdx.x % n_col_tiles) * kBlockN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment coordinates

  float acc[kMTiles][kNTiles][4];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  // ldmatrix addresses: lane l reads row l % 8 of matrix l / 8
  const int a_row = warp * kWarpM + (lane % 8) + ((lane / 8) % 2) * 8;
  const int a_col = (lane / 16) * 8;
  const int b_row = (lane % 8) + ((lane / 8) % 2) * 8;
  const int b_col = (lane / 16) * 8;

  for (int k0 = 0; k0 < K; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous slice
    load_slice<kVec>(sA, sB, x, w, m0, n0, k0, M, K, N);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBlockK; ks += 16) {
      uint32_t a[kMTiles][4];
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
        ldmatrix_x4(a[mt], sA + (a_row + mt * 16) * kLdA + ks + a_col);
#pragma unroll
      for (int np = 0; np < kNTiles / 2; ++np) {
        // b[0], b[1]: n8 tile 2np; b[2], b[3]: n8 tile 2np + 1
        uint32_t b[4];
        ldmatrix_x4_trans(b, sB + (ks + b_row) * kLdB + np * 16 + b_col);
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          mma_bf16_16816(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16_16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }

  // epilogue 1: Y in bf16
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
    const int r_lo = m0 + warp * kWarpM + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      const int c = n0 + nt * 8 + tig * 2;
      store_pair<kVec>(y, r_lo, c, acc[mt][nt][0], acc[mt][nt][1], M, N);
      store_pair<kVec>(y, r_lo + 8, c, acc[mt][nt][2], acc[mt][nt][3], M, N);
    }
  }

  // epilogue 2: per-column sum and sum of squares of the f32 accumulators,
  // over this thread's 4 rows, then the warp's 32 (lanes that share tig)
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        const float lo = acc[mt][nt][e], hi = acc[mt][nt][2 + e];
        s += lo + hi;
        q += lo * lo + hi * hi;
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        q += __shfl_xor_sync(0xffffffffu, q, off);
      }
      if (g == 0) {
        sRed[0][warp][nt * 8 + tig * 2 + e] = s;
        sRed[1][warp][nt * 8 + tig * 2 + e] = q;
      }
    }
  }
  __syncthreads();
  // threads 0..63 finish the sums, 64..127 the sums of squares, warps in order
  const int which = threadIdx.x / kBlockN, col = threadIdx.x % kBlockN;
  float total = 0.f;
#pragma unroll
  for (int wi = 0; wi < kWarps; ++wi) total += sRed[which][wi][col];
  if (n0 + col < N) (which ? ps2 : ps1)[(size_t)row_tile * N + n0 + col] = total;
}

}  // namespace

// C interface (loaded with ctypes). x: [M, K] bf16; w: [K, N] bf16; y:
// [M, N] bf16; ps1, ps2: [num_row_tiles, N] f32 partial column sums of Y and
// of Y^2, num_row_tiles = ceil(M / 128). All contiguous. Returns the CUDA
// error code of the launch (0 = launched).
extern "C" int dls_matmul_stats_bf16(const void* x, const void* w, void* y,
                                     void* ps1, void* ps2, int M, int K, int N,
                                     int num_row_tiles, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 ||
      num_row_tiles != (M + kBlockM - 1) / kBlockM)
    return (int)cudaErrorInvalidValue;
  const int n_col_tiles = (N + kBlockN - 1) / kBlockN;
  const long blocks = (long)num_row_tiles * n_col_tiles;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const bool vec = K % 8 == 0 && N % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w);
  __nv_bfloat16* yp = static_cast<__nv_bfloat16*>(y);
  float* p1 = static_cast<float*>(ps1);
  float* p2 = static_cast<float*>(ps2);
  if (vec)
    matmul_stats_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(
        xp, wp, yp, p1, p2, M, K, N, n_col_tiles);
  else
    matmul_stats_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(
        xp, wp, yp, p1, p2, M, K, N, n_col_tiles);
  return (int)cudaGetLastError();
}

// The row tile the caller sizes the partial-sum scratch by.
extern "C" int dls_matmul_stats_block_m() { return kBlockM; }
