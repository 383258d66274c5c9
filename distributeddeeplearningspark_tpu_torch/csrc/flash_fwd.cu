// FlashAttention-2 forward for Hopper (sm_90a): bf16 in, f32 accumulation.
//
// Replaces the Pallas kernel `_fwd_kernel` driven by `_flash_fwd` in
// distributeddeeplearningspark_tpu/ops/flash_attention.py. It computes what
// that kernel computes, not its block structure:
//
//   - one thread block of 4 warps per (batch*head, 64-row q tile); each warp
//     owns 16 q rows. The loop over 64-key K/V tiles inside the block takes
//     the place of the TPU grid's sequential ("arbitrary") K dimension.
//   - QK^T and PV run on the tensor cores through mma.sync m16n8k16
//     (bf16 operands, f32 accumulators). The running row max m, the row sum
//     l and the output accumulator stay in registers, in f32.
//   - the softmax scale is applied to the f32 logits; P is rounded to bf16
//     (v's dtype) before PV, as the TPU kernel does.
//   - masked logits take the finite value -1e30 and p is exactly 0 under the
//     mask; a fully masked row emits O = 0 and LSE = -1e30.
//   - causal attention skips whole key tiles above the diagonal.
//   - the key padding mask and segment ids are indexed by the batch; GQA
//     reads kv head h / (H / Hkv) in place, K and V are never repeated.
//   - q, k, v and o are read and written in their [B, S, H, D] layout; LSE
//     is a plain [B*H, S] f32 array.
//
// Bound on the card: at BERT-base (B=32, H=12, S=512, D=64) the kernel must
// move q, k, v and o (~100.7 MB) and do 4*B*H*S^2*D ~ 25.8 GFLOP; at
// 3.35 TB/s and 989 TFLOP/s both take ~26-30 us, so neither dominates. This
// first version loads each K/V tile synchronously into shared memory (no
// cp.async/TMA pipeline, no wgmma); it is correct and simple, and faster
// versions are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;   // q rows per thread block (4 warps x 16)
constexpr int kBlockK = 64;   // keys per K/V tile
constexpr int kThreads = 128;
constexpr float kMaskValue = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + 64) of a strided [S, D] bf16 matrix into shared
// memory (row stride LDS elements), 16 bytes per thread per step; rows past
// S are zero-filled so that they can never inject NaN into a product.
template <int D, int LDS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int S, long row_stride) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) {
      val = *reinterpret_cast<const uint4*>(src + (long)(row0 + r) * row_stride
                                            + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * LDS + c * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ kv_mask,
                 const int* __restrict__ q_segs,
                 const int* __restrict__ kv_segs,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int S, int H, int Hkv, float scale, int causal) {
  constexpr int LDS = D + 8;          // padded smem row: conflict-free frags
  constexpr int kSteps = D / 16;      // k-steps of Q K^T
  constexpr int kDTiles = D / 8;      // n-tiles of the O accumulator
  constexpr int kNTiles = kBlockK / 8;  // n-tiles of one S tile

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kBlockQ * LDS;
  __nv_bfloat16* sV = sK + kBlockK * LDS;
  int* sKeyOk = reinterpret_cast<int*>(sV + kBlockK * LDS);
  int* sKeySeg = sKeyOk + kBlockK;

  const int n_tiles = (S + kBlockQ - 1) / kBlockQ;
  const int qt = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / H, h = bh % H;
  const int hkv = h / (H / Hkv);     // GQA: q head h reads kv head h/group
  const int q0 = qt * kBlockQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;  // this thread's q rows
  const bool has_segs = q_segs != nullptr;

  const long q_stride = (long)H * D;
  const long kv_stride = (long)Hkv * D;
  const __nv_bfloat16* q_base = q + (long)b * S * q_stride + (long)h * D;
  const __nv_bfloat16* k_base = k + (long)b * S * kv_stride + (long)hkv * D;
  const __nv_bfloat16* v_base = v + (long)b * S * kv_stride + (long)hkv * D;

  load_tile<D, LDS>(sQ, q_base, q0, S, q_stride);
  __syncthreads();
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const __nv_bfloat16* p = sQ + ks * 16 + tig * 2;
    qf[ks][0] = ld_u32(p + r_lo * LDS);
    qf[ks][1] = ld_u32(p + r_hi * LDS);
    qf[ks][2] = ld_u32(p + r_lo * LDS + 8);
    qf[ks][3] = ld_u32(p + r_hi * LDS + 8);
  }
  const int seg_lo = (has_segs && q0 + r_lo < S) ? q_segs[(long)b * S + q0 + r_lo] : 0;
  const int seg_hi = (has_segs && q0 + r_hi < S) ? q_segs[(long)b * S + q0 + r_hi] : 0;

  float acc[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_lo = kMaskValue, m_hi = kMaskValue;  // running row max
  float l_lo = 0.f, l_hi = 0.f;  // this thread's share of the row sum

  // causal: key tiles strictly above the diagonal contribute nothing
  const int kt_end = causal ? min(n_tiles, qt + 1) : n_tiles;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, LDS>(sK, k_base, k0, S, kv_stride);
    load_tile<D, LDS>(sV, v_base, k0, S, kv_stride);
    if (threadIdx.x < kBlockK) {
      const int key = k0 + threadIdx.x;
      sKeyOk[threadIdx.x] =
          key < S && (kv_mask == nullptr || kv_mask[(long)b * S + key] != 0);
      sKeySeg[threadIdx.x] = (has_segs && key < S) ? kv_segs[(long)b * S + key] : 0;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const __nv_bfloat16* p = sK + (j * 8 + g) * LDS + ks * 16 + tig * 2;
        mma_bf16_16816(s[j], qf[ks][0], qf[ks][1], qf[ks][2], qf[ks][3],
                       ld_u32(p), ld_u32(p + 8));
      }
    }

    // scale, mask, and the tile's row max
    uint32_t allowed = 0;  // bit j*4+e: element s[j][e] may attend
    float mx_lo = kMaskValue, mx_hi = kMaskValue;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + tig * 2 + (e & 1);
        const bool lo = e < 2;
        const int qpos = q0 + (lo ? r_lo : r_hi);
        const bool ok = sKeyOk[col] && (!causal || qpos >= k0 + col) &&
                        (!has_segs || sKeySeg[col] == (lo ? seg_lo : seg_hi));
        const float x = ok ? s[j][e] * scale : kMaskValue;
        s[j][e] = x;
        allowed |= (uint32_t)ok << (j * 4 + e);
        if (lo) mx_lo = fmaxf(mx_lo, x); else mx_hi = fmaxf(mx_hi, x);
      }
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float mnew_lo = fmaxf(m_lo, mx_lo), mnew_hi = fmaxf(m_hi, mx_hi);
    const float corr_lo = exp2f((m_lo - mnew_lo) * kLog2e);
    const float corr_hi = exp2f((m_hi - mnew_hi) * kLog2e);
    m_lo = mnew_lo;
    m_hi = mnew_hi;

    // p = exp(s - m), exactly 0 under the mask
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        const float p = ((allowed >> (j * 4 + e)) & 1u)
                            ? exp2f((s[j][e] - (lo ? m_lo : m_hi)) * kLog2e)
                            : 0.f;
        s[j][e] = p;
        if (lo) sum_lo += p; else sum_hi += p;
      }
    }
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      acc[dt][0] *= corr_lo;
      acc[dt][1] *= corr_lo;
      acc[dt][2] *= corr_hi;
      acc[dt][3] *= corr_hi;
    }

    // O += P V, P rounded to bf16 straight from the S accumulators
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t a0 = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        const __nv_bfloat16* p = sV + (kk * 16 + tig * 2) * LDS + dt * 8 + g;
        const uint32_t b0 = pack_bf16(p[0], p[LDS]);
        const uint32_t b1 = pack_bf16(p[8 * LDS], p[9 * LDS]);
        mma_bf16_16816(acc[dt], a0, a1, a2, a3, b0, b1);
      }
    }
  }

  // finalize: full row sums, O = acc / l, LSE = m + log(l)
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float ls_lo = l_lo == 0.f ? 1.f : l_lo;  // fully masked row: O = 0
  const float ls_hi = l_hi == 0.f ? 1.f : l_hi;
  const int row_lo = q0 + r_lo, row_hi = q0 + r_hi;
  __nv_bfloat16* o_base = o + (long)b * S * q_stride + (long)h * D;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int col = dt * 8 + tig * 2;
    if (row_lo < S)
      *reinterpret_cast<__nv_bfloat162*>(o_base + row_lo * q_stride + col) =
          __floats2bfloat162_rn(acc[dt][0] / ls_lo, acc[dt][1] / ls_lo);
    if (row_hi < S)
      *reinterpret_cast<__nv_bfloat162*>(o_base + row_hi * q_stride + col) =
          __floats2bfloat162_rn(acc[dt][2] / ls_hi, acc[dt][3] / ls_hi);
  }
  if (tig == 0) {
    if (row_lo < S) lse[(long)bh * S + row_lo] = m_lo + logf(ls_lo);
    if (row_hi < S) lse[(long)bh * S + row_hi] = m_hi + logf(ls_hi);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* kv_mask,
           const void* q_segs, const void* kv_segs, void* o, void* lse, int B,
           int S, int H, int Hkv, float scale, int causal,
           cudaStream_t stream) {
  constexpr int LDS = D + 8;
  const size_t smem = (size_t)(kBlockQ + 2 * kBlockK) * LDS * sizeof(__nv_bfloat16)
                      + 2 * kBlockK * sizeof(int);
  // above 48 KB (D = 128) only with the opt-in attribute; harmless below it
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)B * H * ((S + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<D><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(kv_mask),
      static_cast<const int*>(q_segs), static_cast<const int*>(kv_segs),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), S, H, Hkv,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). q, o: [B, S, H, D] bf16; k, v:
// [B, S, Hkv, D] bf16; kv_mask, q_segs, kv_segs: [B, S] int32 or null (segs
// both or neither); lse: [B*H, S] f32. All contiguous. Returns the CUDA error
// code of the launch (0 = launched).
extern "C" int dls_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                  const void* kv_mask, const void* q_segs,
                                  const void* kv_segs, void* o, void* lse,
                                  int B, int S, int H, int Hkv, int D,
                                  float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, kv_mask, q_segs, kv_segs, o, lse, B, S, H, Hkv,
                      scale, causal, st);
  if (D == 128)
    return launch<128>(q, k, v, kv_mask, q_segs, kv_segs, o, lse, B, S, H, Hkv,
                       scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
