// Y = X @ W with each column's sum(Y) and sum(Y^2) taken in the epilogue,
// for Hopper (sm_90a): bf16 operands, f32 accumulation.
//
// Replaces the Pallas kernel `_mm_stats_kernel` driven by `_matmul_stats_fwd`
// and `matmul_stats` in distributeddeeplearningspark_tpu/ops/conv_bn.py (the
// fused 1x1-conv + BatchNorm-statistics matmul of the ResNet bottlenecks). It
// computes what that kernel computes, not its block structure: Y rounded to
// bf16 (round to nearest even), and the column sums from the f32
// accumulator, not from the rounded Y. The TPU kernel's [nm, 8, N]
// replicated-sublane partial sums are a Mosaic layout workaround and are not
// carried over.
//
// Contract: x [M, K], w [K, N], y [M, N] bf16, contiguous, 16-byte aligned,
// K and N multiples of 8 (TMA wants every row stride a multiple of 16
// bytes); the wrapper raises on anything else. ps1, ps2 [P, N] f32 receive
// one partial row per (row group, column tile) of the grid, P from
// dls_matmul_stats_partials(M, N); the wrapper sums them over P.
//
// Bound on the card: the kernel must read X and W and write Y (and 2N f32
// sums) once, and does 2*M*K*N operations. At ResNet-50's ten fused shapes
// (b=256, 224^2) that is, at 3.35 TB/s and 989 TFLOP/s:
//
//   (M, K, N)             bytes ms   ops ms   bound
//   (802816,   64,   64)   0.0614    0.0066   bytes
//   (802816,   64,  256)   0.1534    0.0266   bytes
//   (802816,  256,   64)   0.1534    0.0266   bytes
//   (802816,  256,  128)   0.1841    0.0532   bytes
//   (200704,  128,  512)   0.0767    0.0266   bytes
//   (200704,  512,  128)   0.0767    0.0266   bytes
//   (200704,  512,  256)   0.0921    0.0532   bytes
//   ( 50176,  256, 1024)   0.0385    0.0266   bytes
//   ( 50176, 1024,  256)   0.0385    0.0266   bytes
//   ( 50176, 1024,  512)   0.0463    0.0532   operations
//
// so nine shapes want X streamed in and Y streamed out near the memory
// rate, and one wants the tensor cores kept fed. What each part of the
// design does about that:
//
//   1. Persistent grid, static schedule. About one block per SM, each of
//      three warpgroups: warpgroups 0 and 1 consume (setmaxnreg 232), 64
//      rows of a 128-row tile each; warpgroup 2 produces (setmaxnreg 40),
//      one thread issuing TMA copies. Block b owns column tile b % n_col for
//      its whole life and walks the row tiles b / n_col, + R, + 2R, ... (R
//      blocks per column tile), so the n_col blocks that share a row tile
//      run it at about the same time and X crosses device memory once,
//      served to the others from L2. BN, the tile's width, is a template
//      value, 128 unless the last column tile would waste half of it, else
//      64. BN = 256 (128 accumulators a thread, room for one staging tile a
//      warpgroup and 3 ring stages) measured slower than 128 at every shape
//      that would have picked it, so it is not built.
//   2. TMA ring for the K loop. X slices (128 rows x 64 columns, one
//      128-byte swizzled box) and W slices (64 rows x BN, BN/64 boxes) stream
//      through a ring of 5 to 8 stages with full and empty mbarriers, across
//      tile boundaries, so the next tile's loads are in flight during this
//      tile's products and epilogue. Where the whole K x BN slab of W fits in
//      64 KB (K <= 256 at BN = 128, K <= 512 at BN = 64), the producer loads
//      it once per block and the ring carries X only. Rows past M, columns
//      past N and the K tail past K read as zeros: they add nothing to the
//      products or the sums, and are never stored.
//   3. wgmma from shared memory: m64nBNk16, A = the X slice K-major, B = the
//      W slice MN-major through the transpose bit (W is [K, N], N
//      contiguous). Each slice's descriptors are made and pinned before the
//      wgmma.fence that opens its products, so ptxas keeps them asynchronous.
//   4. Epilogue overlapped with the next tile. Each consumer warpgroup
//      rounds its accumulator to bf16 into one of its two swizzled
//      shared-memory staging tiles and one thread issues TMA stores of it;
//      the warpgroup goes on to the next tile's products while the stores
//      drain, and reuses a staging tile once its store has read it.
//   5. Deterministic column sums. Per tile, each thread adds its two rows of
//      each of its columns, then (at BN = 128) one halving step of a
//      reduce-scatter over the lanes that share its columns, so that it
//      carries 16 columns' sum and sum of squares across tiles, in
//      registers. At the end of the block the remaining lanes, then the 8
//      consumer warps in a fixed order through shared memory, give one
//      partial row per block: P = R rows (132 / n_col) instead of one per
//      128-row tile. No atomics: the same inputs give the same bits.
//   6. The 16-byte rule: K and N multiples of 8 (every ResNet shape is); no
//      element-wise load path.

#include "sm90.cuh"

namespace {

constexpr int kThreads = 384;                  // warpgroups 0, 1 consume; 2 produces
constexpr int kBlockM = 128;                   // rows of a Y tile
constexpr int kSliceK = kBoxCols;              // depth of a K slice
constexpr int kXBytes = kBlockM * kRowBytes;   // one X slice: 16 KB
constexpr int kWBoxBytes = kSliceK * kRowBytes;  // 64 rows x 64 columns of W
constexpr int kMaxSlab = 64 * 1024;            // largest resident W slab
constexpr int kBarBytes = 1024;  // the mbarriers; keeps the slab 1024-aligned

template <int BN, bool RESIDENT>
struct Cfg {
  static constexpr int kWBytes = (BN / 64) * kWBoxBytes;  // one W slice
  static constexpr int kStageBytes = kXBytes + (RESIDENT ? 0 : kWBytes);
  static constexpr int kStages = BN == 64 ? 8 : (RESIDENT ? 6 : 5);
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kStagingBytes = 64 * BN * 2;  // 64 rows of Y
  // the ring, two staging tiles for each warpgroup, the barriers; a resident
  // slab follows at run time
  static constexpr int kFixedBytes = kRingBytes + 4 * kStagingBytes + kBarBytes;
  static_assert(1024 + kFixedBytes + (RESIDENT ? kMaxSlab : 0) <= kMaxSmem,
                "shared memory");
  static_assert(2 * 8 * BN * 4 <= kRingBytes, "the end's reduction");
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// Fold a tile's f32 accumulators into the running column sums. Thread
// (g, tig) holds rows g and g + 8 of columns 8j + 2tig + e of its 64-row
// slab (accumulator index 4j + e and 4j + 2 + e); its i-th column is
// (j, e) = (i / 2, i % 2). The two rows are added; at BN = 128 one halving
// step of a reduce-scatter with the lane 4 apart (g ^ 1) then leaves each
// thread NK = 16 columns over 4 rows: i = k + (g & 1) * NK.
template <int BN>
__device__ __forceinline__ void add_column_sums(const float (&acc)[BN / 2],
                                                float (&cs)[16], float (&cq)[16],
                                                int g) {
  constexpr int NK = 16;
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    float s[BN / 64], q[BN / 64];  // columns k and, at BN = 128, k + NK
#pragma unroll
    for (int a = 0; a < BN / 64; ++a) {
      const int i = k + a * NK;
      const float lo = acc[4 * (i / 2) + i % 2], hi = acc[4 * (i / 2) + 2 + i % 2];
      s[a] = lo + hi;
      q[a] = fmaf(lo, lo, hi * hi);
    }
    if constexpr (BN == 128) {
      const bool up = g & 1;  // keeps column k + NK
      s[0] = (up ? s[1] : s[0]) + __shfl_xor_sync(0xffffffffu, up ? s[0] : s[1], 4);
      q[0] = (up ? q[1] : q[0]) + __shfl_xor_sync(0xffffffffu, up ? q[0] : q[1], 4);
    }
    cs[k] += s[0];
    cq[k] += q[0];
  }
}

template <int BN, bool RESIDENT>
__global__ void __launch_bounds__(kThreads, 1)
matmul_stats_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_w,
                    const __grid_constant__ CUtensorMap tm_y,
                    float* __restrict__ ps1, float* __restrict__ ps2, int M,
                    int K, int N, int R) {
  using C = Cfg<BN, RESIDENT>;
  constexpr int NS = C::kStages;
  constexpr int H = BN / 64 - 1;  // halving steps of add_column_sums
  constexpr int NK = 16;          // columns a thread carries

  // Shared memory (1024-byte aligned, as the 128-byte swizzle wants): the
  // ring of {X slice, W slice} stages, the staging tiles [warpgroup][buf],
  // the barriers, then the resident W slab [K slice][BN/64 boxes].
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  // the ring's room, reused for the block's column sums at the end
  float* red = reinterpret_cast<float*>(smem_raw + (base - raw));
  const uint32_t sRing = base;
  const uint32_t sStaging = sRing + C::kRingBytes;
  const uint32_t bar0 = sStaging + 4 * C::kStagingBytes;
  const uint32_t sSlab = bar0 + kBarBytes;
  auto barFull = [&](int st) { return bar0 + 8u * st; };
  auto barEmpty = [&](int st) { return bar0 + 8u * (NS + st); };
  const uint32_t barSlab = bar0 + 8u * 2 * NS;

  const int n_col = (N + BN - 1) / BN;
  const int n_row = (M + kBlockM - 1) / kBlockM;
  const int n_k = (K + kSliceK - 1) / kSliceK;
  const int group = blockIdx.x / n_col;  // first row tile; partial row
  const int n0 = (blockIdx.x % n_col) * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int st = 0; st < NS; ++st) {
      mbar_init(barFull(st), 1);
      mbar_init(barEmpty(st), 2 * 128);
    }
    mbar_init(barSlab, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      if (RESIDENT) {
        mbar_expect_tx(barSlab, n_k * C::kWBytes);
        for (int kt = 0; kt < n_k; ++kt)
          for (int box = 0; box < BN / 64; ++box)
            tma_load(sSlab + kt * C::kWBytes + box * kWBoxBytes, &tm_w,
                     barSlab, n0 + box * 64, 0, kt * kSliceK, 0);
      }
      int st = 0;
      uint32_t phase = 0;
      for (int r = group; r < n_row; r += R) {
        for (int kt = 0; kt < n_k; ++kt) {
          mbar_wait(barEmpty(st), phase ^ 1);  // first pass: free
          mbar_expect_tx(barFull(st), C::kStageBytes);
          const uint32_t dst = sRing + st * C::kStageBytes;
          tma_load(dst, &tm_x, barFull(st), kt * kSliceK, 0, r * kBlockM, 0);
          if (!RESIDENT)
            for (int box = 0; box < BN / 64; ++box)
              tma_load(dst + kXBytes + box * kWBoxBytes, &tm_w, barFull(st),
                       n0 + box * 64, 0, kt * kSliceK, 0);
          if (++st == NS) {
            st = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of a tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);
    const int g = lane >> 2, tig = lane & 3;
    const bool storer = warp % 4 == 0 && lane == 0;
    float acc[BN / 2];
    float cs[NK], cq[NK];
#pragma unroll
    for (int k = 0; k < NK; ++k) cs[k] = cq[k] = 0.f;
    uint32_t one = 1;
    asm volatile("" : "+r"(one));
    if (RESIDENT) mbar_wait(barSlab, 0);
    int st = 0, tiles = 0;
    uint32_t phase = 0;
    for (int r = group; r < n_row; r += R, ++tiles) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < n_k; ++kt) {
        const uint32_t x_addr = sRing + st * C::kStageBytes + wg * 64 * kRowBytes;
        const uint32_t w_addr = RESIDENT ? sSlab + kt * C::kWBytes
                                         : sRing + st * C::kStageBytes + kXBytes;
        uint64_t da[kSliceK / 16], db[kSliceK / 16];
#pragma unroll
        for (int ks = 0; ks < kSliceK / 16; ++ks) {
          da[ks] = smem_desc(x_addr + ks * 32, 16, 8 * kRowBytes);
          // MN-major B: 8 K rows a 1024-byte swizzle atom (stride offset),
          // 64 columns a box (leading offset)
          db[ks] = smem_desc(w_addr + ks * 16 * kRowBytes, kWBoxBytes,
                             8 * kRowBytes);
        }
        pin(da);
        pin(db);
        pin(acc);
        mbar_wait(barFull(st), phase);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kSliceK / 16; ++ks)
          wgmma_ss_mn(acc, da[ks], db[ks], one);
        wgmma_commit();
        wgmma_wait<0>();
        pin(acc);
        mbar_arrive(barEmpty(st));
        if (++st == NS) {
          st = 0;
          phase ^= 1;
        }
      }

      add_column_sums<BN>(acc, cs, cq, g);

      // Y: bf16 into this warpgroup's staging tile (128-byte swizzle, as the
      // map's), once its last store has read it; then TMA stores of 64 rows
      const int row0 = r * kBlockM + wg * 64;
      const uint32_t stg = sStaging + (2 * wg + tiles % 2) * C::kStagingBytes;
      if (storer) bulk_wait_read_upto<1>();  // the other tile's may go on
      named_sync(1 + wg, 128);
#pragma unroll
      for (int dt = 0; dt < BN / 8; ++dt) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = (warp % 4) * 16 + g + 8 * hf;
          const uint32_t addr = stg + (dt / 8) * 64 * kRowBytes + row * kRowBytes +
                                (((dt % 8) ^ (row & 7)) * 16) + tig * 4;
          asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr),
                       "r"(pack_bf16(acc[4 * dt + 2 * hf], acc[4 * dt + 2 * hf + 1]))
                       : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + wg, 128);
      if (storer && row0 < M) {
#pragma unroll
        for (int box = 0; box < BN / 64; ++box)
          tma_store(&tm_y, stg + box * 64 * kRowBytes, n0 + box * 64, 0, row0, 0);
        bulk_commit();
      }
    }

    // The block's partial row: the lanes not yet reduced (butterflies, so
    // both partners hold the same sum), then the 8 warps in order through
    // shared memory, [warp][sum, sum of squares][BN], in the ring's room
    // once no consumer reads it.
#pragma unroll
    for (int h = H; h < 3; ++h) {
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        cs[k] += __shfl_xor_sync(0xffffffffu, cs[k], 4 << h);
        cq[k] += __shfl_xor_sync(0xffffffffu, cq[k], 4 << h);
      }
    }
    named_sync(3, 2 * 128);
    if ((g >> H) == 0) {
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const int i = k + (g & H) * NK;
        const int col = 8 * (i / 2) + 2 * tig + i % 2;
        red[(2 * warp) * BN + col] = cs[k];
        red[(2 * warp + 1) * BN + col] = cq[k];
      }
    }
    named_sync(3, 2 * 128);
    if (tid < BN && n0 + tid < N) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        s += red[(2 * w) * BN + tid];
        q += red[(2 * w + 1) * BN + tid];
      }
      ps1[static_cast<size_t>(group) * N + n0 + tid] = s;
      ps2[static_cast<size_t>(group) * N + n0 + tid] = q;
    }
    if (storer) bulk_wait();  // Y's last stores, before the block ends
  }
}

// -- host side -----------------------------------------------------------------

// The tile width: 128 unless its last column tile would waste half or more.
int pick_bn(int N) { return (N + 127) / 128 * 128 - N < 64 ? 128 : 64; }

// Blocks per column tile (and the partial rows): about one block per SM,
// never more than the row tiles.
int row_groups(int M, int N, int sms) {
  const int n_col = (N + pick_bn(N) - 1) / pick_bn(N);
  const int n_row = (M + kBlockM - 1) / kBlockM;
  const int groups = sms / n_col;
  return groups < 1 ? 1 : (groups < n_row ? groups : n_row);
}

// The current device's SM count, once per device.
cudaError_t sm_count(int& sms) {
  static int count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (count[dev] == 0) {
    err = cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  sms = count[dev];
  return cudaSuccess;
}

template <int BN, bool RESIDENT>
int launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
           const CUtensorMap& tm_y, float* ps1, float* ps2, int M, int K, int N,
           int groups, cudaStream_t stream) {
  using C = Cfg<BN, RESIDENT>;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {  // once per device and kernel
    err = cudaFuncSetAttribute(matmul_stats_kernel<BN, RESIDENT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const int n_k = (K + kSliceK - 1) / kSliceK;
  const size_t smem = 1024 + C::kFixedBytes + (RESIDENT ? (size_t)n_k * C::kWBytes : 0);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int blocks = groups * ((N + BN - 1) / BN);
  matmul_stats_kernel<BN, RESIDENT><<<blocks, kThreads, smem, stream>>>(
      tm_x, tm_w, tm_y, ps1, ps2, M, K, N, groups);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). x: [M, K] bf16; w: [K, N] bf16; y:
// [M, N] bf16; ps1, ps2: [partials, N] f32 partial column sums of Y and of
// Y^2, partials = dls_matmul_stats_partials(M, N) on the current device. All
// contiguous and 16-byte aligned, K and N multiples of 8. Returns the CUDA
// error code of the launch (0 = launched).
extern "C" int dls_matmul_stats_bf16(const void* x, const void* w, void* y,
                                     void* ps1, void* ps2, int M, int K, int N,
                                     int partials, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return (int)err;
  const int groups = row_groups(M, N, sms);
  if (partials != groups) return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap tm_x, tm_w, tm_y;
  if (!make_map(&tm_x, x, 1, M, 1, K, kBlockM) ||
      !make_map(&tm_w, w, 1, K, 1, N, kSliceK) ||
      !make_map(&tm_y, y, 1, M, 1, N, 64))
    return (int)cudaErrorNotSupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p1 = static_cast<float*>(ps1);
  float* p2 = static_cast<float*>(ps2);
  const int bn = pick_bn(N);
  const int slab = (K + kSliceK - 1) / kSliceK * bn * 128;  // W's K x BN, bytes
  const bool resident = slab <= kMaxSlab;
  if (bn == 128)
    return resident ? launch<128, true>(tm_x, tm_w, tm_y, p1, p2, M, K, N, groups, st)
                    : launch<128, false>(tm_x, tm_w, tm_y, p1, p2, M, K, N, groups, st);
  return resident ? launch<64, true>(tm_x, tm_w, tm_y, p1, p2, M, K, N, groups, st)
                  : launch<64, false>(tm_x, tm_w, tm_y, p1, p2, M, K, N, groups, st);
}

// The partial rows the caller sizes ps1 and ps2 by, on the current device
// (0 on a CUDA error).
extern "C" int dls_matmul_stats_partials(int M, int N) {
  int sms = 0;
  if (M <= 0 || N <= 0 || sm_count(sms) != cudaSuccess) return 0;
  return row_groups(M, N, sms);
}
