// FlashAttention-2 backward for Hopper (sm_90a): bf16 in, f32 accumulation.
//
// Two kernels, each with its own C entry point so that they can be timed
// apart. They replace the Pallas kernels driven by `_flash_bwd` in
// distributeddeeplearningspark_tpu/ops/flash_attention.py and compute what
// those compute, not their block structure: the TPU grids carry their
// accumulators across a sequential grid axis, which CUDA blocks cannot do,
// so a loop inside each block takes that axis's place.
//
//   K2, flash_bwd_dq_kernel (replaces `_bwd_dq_kernel`): one thread block of
//     4 warps per (batch*head, 64-row q tile), each warp owning 16 q rows.
//     It loops over the 64-key K/V tiles (under causal up to the diagonal
//     tile) and per tile recomputes S = scale*q*k^T and P = exp(S - LSE),
//     then dP = dO*V^T, dS = P*(dP - delta) and acc += dS*K. It writes
//     dQ = scale*acc in q's dtype.
//   K3, flash_bwd_dkv_kernel (replaces `_bwd_dkv_kernel`): one thread block
//     of 4 warps per (batch*kv head, 64-key tile), each warp owning 16 keys.
//     It loops over the group's q heads and, inside each, over the 64-row q
//     tiles (under causal from the diagonal tile), working on the transposed
//     products: S^T = k*q^T, dP^T = v*dO^T, dV += P^T*dO, dK += dS^T*q. The
//     dK and dV accumulators stay in f32 registers; GQA is folded in the
//     loop, never through repeated K/V. dK = scale*acc.
//
// Both kernels:
//   - work in 16-column chunks of the 64-wide score tile, so that only the
//     chunk's S and dP accumulators are live beside the output accumulators
//     (at D = 128, K3 holds 2 x 64 f32 accumulators per thread; the chunking
//     and reading every mma operand from shared memory, never caching q/k/v
//     fragments in registers, keep it clear of spills without 8 warps);
//   - compute P, dP and dS in f32 and round P and dS to bf16 only as
//     operands of the next mma.sync m16n8k16 (the Pallas kernels keep them
//     in f32: that rounding is the difference the card checks allow for);
//   - zero P with the mask bits, never through the exponent: a fully masked
//     row has LSE = -1e30, where exp(S - LSE) would be 1;
//   - index the key padding mask and segment ids by the batch; q, k, v, dO
//     and the gradients are read and written in their [B, S, H, D] layout,
//     LSE and delta (rowsum(dO*O), computed outside, as the JAX package
//     computes it in XLA) are plain [B*H, S] f32 arrays;
//   - use no atomics, so the gradients are deterministic.
//
// Bound on the card at the training shape (B=32, S=512, H=12, D=64, all keys
// allowed): q, k, v, o, dO read and dQ, dK, dV written, 8 x 25.2 MB, plus
// LSE and delta, ~203 MB -> 0.061 ms at 3.35 TB/s; the five products of the
// backward, 5 x 2*B*H*S^2*D = 64 GFLOP -> 0.065 ms at 989 TFLOP/s, so the
// pair is bound by operations by a small margin. This first version loads
// tiles synchronously into shared memory (no cp.async/TMA pipeline, no
// wgmma, K2 and K3 not merged); it is correct and simple, and faster
// versions are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // q rows and keys per tile
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The mma A operand (16 x 16, row-major) at rows [r0, r0 + 16) and columns
// [c0, c0 + 16) of a row-major shared-memory matrix with row stride LDS.
template <int LDS>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* m,
                                       int r0, int c0) {
  const int lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* p = m + (r0 + g) * LDS + c0 + tig * 2;
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * LDS);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * LDS + 8);
}

// The mma A operand built from two f32 accumulator tiles (columns
// [0, 8) and [8, 16) of a 16 x 16 block), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&x0)[4],
                                         const float (&x1)[4]) {
  a[0] = pack_f32(x0[0], x0[1]);
  a[1] = pack_f32(x0[2], x0[3]);
  a[2] = pack_f32(x1[0], x1[1]);
  a[3] = pack_f32(x1[2], x1[3]);
}

// The mma B operand (16 x 8, "col") with B(k, n) = m[n0 + n][k0 + k]:
// rows of m are the n index, its contiguous columns the k index.
template <int LDS>
__device__ __forceinline__ void load_b_nk(uint32_t& b0, uint32_t& b1,
                                          const __nv_bfloat16* m, int n0, int k0) {
  const int lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* p = m + (n0 + g) * LDS + k0 + tig * 2;
  b0 = ld_u32(p);
  b1 = ld_u32(p + 8);
}

// The mma B operand with B(k, n) = m[k0 + k][n0 + n]: rows of m are the k
// index, so each register packs two rows.
template <int LDS>
__device__ __forceinline__ void load_b_kn(uint32_t& b0, uint32_t& b1,
                                          const __nv_bfloat16* m, int k0, int n0) {
  const int lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* p = m + (k0 + tig * 2) * LDS + n0 + g;
  b0 = pack_bf16(p[0], p[LDS]);
  b1 = pack_bf16(p[8 * LDS], p[9 * LDS]);
}

// Copy rows [row0, row0 + 64) of a strided [S, D] bf16 matrix into shared
// memory (row stride LDS elements), 16 bytes per thread per step; rows past
// S are zero-filled so that they can never inject NaN into a product.
template <int D, int LDS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int S, long row_stride) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) {
      val = *reinterpret_cast<const uint4*>(src + (long)(row0 + r) * row_stride + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * LDS + c * 8) = val;
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)4 * kTile * (D + 8) * sizeof(__nv_bfloat16) + 4 * kTile * sizeof(int);
}

// ---------------------------------------------------------------------------
// K2: dQ
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ kv_mask, const int* __restrict__ q_segs,
                    const int* __restrict__ kv_segs, __nv_bfloat16* __restrict__ dq,
                    int S, int H, int Hkv, float scale, int causal) {
  constexpr int LDS = D + 8;      // padded smem row: conflict-free fragments
  constexpr int kSteps = D / 16;  // k-steps of the products over D
  constexpr int kDTiles = D / 8;  // n-tiles of the dQ accumulator

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdO = sQ + kTile * LDS;
  __nv_bfloat16* sK = sdO + kTile * LDS;
  __nv_bfloat16* sV = sK + kTile * LDS;
  int* sKeyOk = reinterpret_cast<int*>(sV + kTile * LDS);
  int* sKeySeg = sKeyOk + kTile;

  const int n_tiles = (S + kTile - 1) / kTile;
  const int qt = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / H, h = bh % H;
  const int hkv = h / (H / Hkv);  // GQA: q head h reads kv head h/group
  const int q0 = qt * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;  // this thread's q rows
  const bool has_segs = q_segs != nullptr;

  const long q_stride = (long)H * D;
  const long kv_stride = (long)Hkv * D;
  const long q_off = (long)b * S * q_stride + (long)h * D;
  const __nv_bfloat16* k_base = k + (long)b * S * kv_stride + (long)hkv * D;
  const __nv_bfloat16* v_base = v + (long)b * S * kv_stride + (long)hkv * D;

  load_tile<D, LDS>(sQ, q + q_off, q0, S, q_stride);
  load_tile<D, LDS>(sdO, dout + q_off, q0, S, q_stride);
  const bool in_lo = row_lo < S, in_hi = row_hi < S;
  const float lse_lo = in_lo ? lse[(long)bh * S + row_lo] : 0.f;
  const float lse_hi = in_hi ? lse[(long)bh * S + row_hi] : 0.f;
  const float dl_lo = in_lo ? delta[(long)bh * S + row_lo] : 0.f;
  const float dl_hi = in_hi ? delta[(long)bh * S + row_hi] : 0.f;
  const int seg_lo = (has_segs && in_lo) ? q_segs[(long)b * S + row_lo] : 0;
  const int seg_hi = (has_segs && in_hi) ? q_segs[(long)b * S + row_hi] : 0;

  float acc[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  // causal: key tiles strictly above the diagonal contribute nothing
  const int kt_end = causal ? min(n_tiles, qt + 1) : n_tiles;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, LDS>(sK, k_base, k0, S, kv_stride);
    load_tile<D, LDS>(sV, v_base, k0, S, kv_stride);
    if (threadIdx.x < kTile) {
      const int key = k0 + threadIdx.x;
      sKeyOk[threadIdx.x] = key < S && (kv_mask == nullptr || kv_mask[(long)b * S + key] != 0);
      sKeySeg[threadIdx.x] = (has_segs && key < S) ? kv_segs[(long)b * S + key] : 0;
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < kTile / 16; ++c) {  // 16 keys at a time
      float s[2][4], dp[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        uint32_t aq[4], ado[4], b0, b1;
        load_a<LDS>(aq, sQ, warp * 16, ks * 16);
        load_a<LDS>(ado, sdO, warp * 16, ks * 16);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          load_b_nk<LDS>(b0, b1, sK, c * 16 + jj * 8, ks * 16);
          mma_bf16_16816(s[jj], aq, b0, b1);  // S = Q K^T
          load_b_nk<LDS>(b0, b1, sV, c * 16 + jj * 8, ks * 16);
          mma_bf16_16816(dp[jj], ado, b0, b1);  // dP = dO V^T
        }
      }
      // P = exp(scale*S - LSE), exactly 0 under the mask; dS = P (dP - delta)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c * 16 + jj * 8 + tig * 2 + (e & 1);
          const bool lo = e < 2;
          const int qpos = lo ? row_lo : row_hi;
          const bool ok = sKeyOk[col] && qpos < S && (!causal || qpos >= k0 + col) &&
                          (!has_segs || sKeySeg[col] == (lo ? seg_lo : seg_hi));
          const float p =
              ok ? exp2f((s[jj][e] * scale - (lo ? lse_lo : lse_hi)) * kLog2e) : 0.f;
          s[jj][e] = p * (dp[jj][e] - (lo ? dl_lo : dl_hi));
        }
      }
      // acc += dS K over these 16 keys
      uint32_t ads[4];
      acc_to_a(ads, s[0], s[1]);
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        uint32_t b0, b1;
        load_b_kn<LDS>(b0, b1, sK, c * 16, dt * 8);
        mma_bf16_16816(acc[dt], ads, b0, b1);
      }
    }
  }

  __nv_bfloat16* dq_base = dq + q_off;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int col = dt * 8 + tig * 2;
    if (in_lo)
      *reinterpret_cast<__nv_bfloat162*>(dq_base + row_lo * q_stride + col) =
          __floats2bfloat162_rn(acc[dt][0] * scale, acc[dt][1] * scale);
    if (in_hi)
      *reinterpret_cast<__nv_bfloat162*>(dq_base + row_hi * q_stride + col) =
          __floats2bfloat162_rn(acc[dt][2] * scale, acc[dt][3] * scale);
  }
}

// ---------------------------------------------------------------------------
// K3: dK, dV
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ kv_mask, const int* __restrict__ q_segs,
                     const int* __restrict__ kv_segs, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int S, int H, int Hkv, float scale,
                     int causal) {
  constexpr int LDS = D + 8;
  constexpr int kSteps = D / 16;
  constexpr int kDTiles = D / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kTile * LDS;
  __nv_bfloat16* sQ = sV + kTile * LDS;
  __nv_bfloat16* sdO = sQ + kTile * LDS;
  float* sLse = reinterpret_cast<float*>(sdO + kTile * LDS);
  float* sDelta = sLse + kTile;
  int* sQOk = reinterpret_cast<int*>(sDelta + kTile);
  int* sQSeg = sQOk + kTile;

  const int n_tiles = (S + kTile - 1) / kTile;
  const int kt = blockIdx.x % n_tiles;
  const int bhkv = blockIdx.x / n_tiles;
  const int b = bhkv / Hkv, hkv = bhkv % Hkv;
  const int group = H / Hkv;
  const int k0 = kt * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;  // this thread's keys
  const bool has_segs = q_segs != nullptr;

  const long q_stride = (long)H * D;
  const long kv_stride = (long)Hkv * D;
  const long kv_off = (long)b * S * kv_stride + (long)hkv * D;

  load_tile<D, LDS>(sK, k + kv_off, k0, S, kv_stride);
  load_tile<D, LDS>(sV, v + kv_off, k0, S, kv_stride);
  const bool in_lo = key_lo < S, in_hi = key_hi < S;
  const bool ok_lo = in_lo && (kv_mask == nullptr || kv_mask[(long)b * S + key_lo] != 0);
  const bool ok_hi = in_hi && (kv_mask == nullptr || kv_mask[(long)b * S + key_hi] != 0);
  const int kseg_lo = (has_segs && in_lo) ? kv_segs[(long)b * S + key_lo] : 0;
  const int kseg_hi = (has_segs && in_hi) ? kv_segs[(long)b * S + key_hi] : 0;

  float dk_acc[kDTiles][4], dv_acc[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  // causal: q tiles strictly below the key tile's diagonal see none of its keys
  const int qt_begin = causal ? kt : 0;
  for (int gi = 0; gi < group; ++gi) {
    const int h = hkv * group + gi;
    const long bh = (long)b * H + h;
    const long q_off = (long)b * S * q_stride + (long)h * D;
    for (int qt = qt_begin; qt < n_tiles; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // every warp is done with the previous q tile
      load_tile<D, LDS>(sQ, q + q_off, q0, S, q_stride);
      load_tile<D, LDS>(sdO, dout + q_off, q0, S, q_stride);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        const bool in = row < S;
        sLse[threadIdx.x] = in ? lse[bh * S + row] : 0.f;
        sDelta[threadIdx.x] = in ? delta[bh * S + row] : 0.f;
        sQOk[threadIdx.x] = in;
        sQSeg[threadIdx.x] = (has_segs && in) ? q_segs[(long)b * S + row] : 0;
      }
      __syncthreads();

#pragma unroll 1
      for (int c = 0; c < kTile / 16; ++c) {  // 16 q rows at a time
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[jj][e] = dpt[jj][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          uint32_t ak[4], av[4], b0, b1;
          load_a<LDS>(ak, sK, warp * 16, ks * 16);
          load_a<LDS>(av, sV, warp * 16, ks * 16);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            load_b_nk<LDS>(b0, b1, sQ, c * 16 + jj * 8, ks * 16);
            mma_bf16_16816(st[jj], ak, b0, b1);  // S^T = K Q^T
            load_b_nk<LDS>(b0, b1, sdO, c * 16 + jj * 8, ks * 16);
            mma_bf16_16816(dpt[jj], av, b0, b1);  // dP^T = V dO^T
          }
        }
        // P^T and dS^T, the mask bits doing the zeroing
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c * 16 + jj * 8 + tig * 2 + (e & 1);  // q row in the tile
            const bool lo = e < 2;
            const int key = lo ? key_lo : key_hi;
            const bool ok = (lo ? ok_lo : ok_hi) && sQOk[col] &&
                            (!causal || q0 + col >= key) &&
                            (!has_segs || sQSeg[col] == (lo ? kseg_lo : kseg_hi));
            const float p = ok ? exp2f((st[jj][e] * scale - sLse[col]) * kLog2e) : 0.f;
            st[jj][e] = p;
            dpt[jj][e] = p * (dpt[jj][e] - sDelta[col]);
          }
        }
        // dV += P^T dO and dK += dS^T Q over these 16 q rows
        uint32_t ap[4], ads[4];
        acc_to_a(ap, st[0], st[1]);
        acc_to_a(ads, dpt[0], dpt[1]);
#pragma unroll
        for (int dt = 0; dt < kDTiles; ++dt) {
          uint32_t b0, b1;
          load_b_kn<LDS>(b0, b1, sdO, c * 16, dt * 8);
          mma_bf16_16816(dv_acc[dt], ap, b0, b1);
          load_b_kn<LDS>(b0, b1, sQ, c * 16, dt * 8);
          mma_bf16_16816(dk_acc[dt], ads, b0, b1);
        }
      }
    }
  }

  __nv_bfloat16* dk_base = dk + kv_off;
  __nv_bfloat16* dv_base = dv + kv_off;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int col = dt * 8 + tig * 2;
    if (in_lo) {
      *reinterpret_cast<__nv_bfloat162*>(dk_base + key_lo * kv_stride + col) =
          __floats2bfloat162_rn(dk_acc[dt][0] * scale, dk_acc[dt][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_base + key_lo * kv_stride + col) =
          __floats2bfloat162_rn(dv_acc[dt][0], dv_acc[dt][1]);
    }
    if (in_hi) {
      *reinterpret_cast<__nv_bfloat162*>(dk_base + key_hi * kv_stride + col) =
          __floats2bfloat162_rn(dk_acc[dt][2] * scale, dk_acc[dt][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_base + key_hi * kv_stride + col) =
          __floats2bfloat162_rn(dv_acc[dt][2], dv_acc[dt][3]);
    }
  }
}

using bf16 = __nv_bfloat16;

template <int D>
int launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
              const float* lse, const float* delta, const int* kv_mask, const int* q_segs,
              const int* kv_segs, bf16* dq, int B, int S, int H, int Hkv, float scale,
              int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  // above 48 KB (D = 128) only with the opt-in attribute; harmless below it
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)B * H * ((S + kTile - 1) / kTile);
  flash_bwd_dq_kernel<D><<<(unsigned)blocks, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, kv_mask, q_segs, kv_segs, dq, S, H, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
               const float* lse, const float* delta, const int* kv_mask, const int* q_segs,
               const int* kv_segs, bf16* dk, bf16* dv, int B, int S, int H, int Hkv,
               float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)B * Hkv * ((S + kTile - 1) / kTile);
  flash_bwd_dkv_kernel<D><<<(unsigned)blocks, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, kv_mask, q_segs, kv_segs, dk, dv, S, H, Hkv, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). q, dout, dq: [B, S, H, D] bf16; k, v, dk,
// dv: [B, S, Hkv, D] bf16; lse, delta: [B*H, S] f32; kv_mask, q_segs,
// kv_segs: [B, S] int32 or null (segs both or neither). All contiguous. Each
// returns the CUDA error code of its launch (0 = launched).
extern "C" int dls_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     const void* kv_mask, const void* q_segs,
                                     const void* kv_segs, void* dq, int B, int S, int H,
                                     int Hkv, int D, float scale, int causal,
                                     void* stream) {
  using Fn = decltype(&launch_dq<64>);
  const Fn fn = D == 64 ? &launch_dq<64> : D == 128 ? &launch_dq<128> : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
            static_cast<const float*>(lse), static_cast<const float*>(delta),
            static_cast<const int*>(kv_mask), static_cast<const int*>(q_segs),
            static_cast<const int*>(kv_segs), static_cast<bf16*>(dq), B, S, H, Hkv, scale,
            causal, static_cast<cudaStream_t>(stream));
}

extern "C" int dls_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      const void* kv_mask, const void* q_segs,
                                      const void* kv_segs, void* dk, void* dv, int B,
                                      int S, int H, int Hkv, int D, float scale, int causal,
                                      void* stream) {
  using Fn = decltype(&launch_dkv<64>);
  const Fn fn = D == 64 ? &launch_dkv<64> : D == 128 ? &launch_dkv<128> : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
            static_cast<const float*>(lse), static_cast<const float*>(delta),
            static_cast<const int*>(kv_mask), static_cast<const int*>(q_segs),
            static_cast<const int*>(kv_segs), static_cast<bf16*>(dk),
            static_cast<bf16*>(dv), B, S, H, Hkv, scale, causal,
            static_cast<cudaStream_t>(stream));
}
