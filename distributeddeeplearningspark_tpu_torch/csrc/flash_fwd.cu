// FlashAttention forward for Hopper (sm_90a): bf16 in, f32 accumulation.
//
// Replaces the Pallas kernel `_fwd_kernel` driven by `_flash_fwd` in
// distributeddeeplearningspark_tpu/ops/flash_attention.py. It computes what
// that kernel computes (the contract below), not its block structure.
//
// Contract: q [B, S, H, D], k and v [B, S, Hkv, D] bf16, D 64 or 128, any
// S >= 1; GQA q head h reads kv head h / (H / Hkv) in place; a key-only
// mask kv_mask [B, S] and segment ids q_segs/kv_segs [B, S] (int32), causal
// or not. Masked logits take the finite value -1e30 and p is exactly 0 under
// the mask; P is rounded to bf16 before PV; sums are f32; a fully masked row
// emits O = 0 and LSE = -1e30. O is written in q's layout, LSE as a plain
// [B*H, S] f32 array (the backward kernels read it).
//
// Design: a persistent grid, one block of three warpgroups on each SM, each
// block walking its share of the work items (batch*head, 128-row q tile).
//   - Warpgroup 2 gives up registers (setmaxnreg 40). Its warps 9-11 walk
//     the next item's masks (below) while the current one runs; one thread
//     of warp 8 copies with TMA: Q once per item (two buffers), and each
//     128-key K and V tile into a ring of stages (3 at D = 64, 2 at D = 128)
//     that turns across items. Each stage has a K-full, a V-full, a K-empty
//     and a V-empty mbarrier: K is released as soon as S = QK^T is done, V
//     after PV, so the next K copy starts a product earlier.
//   - Warpgroups 0 and 1 consume (setmaxnreg 232), 64 q rows each:
//     S = Q K^T by wgmma m64n128k16 with both operands read from shared
//     memory through descriptors (K-major); the online softmax in registers;
//     O += P V by wgmma with P as the register A operand (the S accumulator's
//     fragment layout is the A operand's, so P is converted to bf16 in
//     registers) and V read in its natural [keys, D] layout as an MN-major B
//     operand (the transpose bit). Tile i's QK^T and tile i-1's PV are issued
//     together and tile i's softmax runs while PV(i-1) is on the tensor
//     cores. Every wgmma input is defined before the wgmma.fence that opens
//     its stage and nothing writes one while a stage is open: otherwise
//     ptxas serializes every wgmma of the kernel (warnings C7513/C7520).
//   - Tensor maps are rank 4 ([B, S, heads, D], innermost first), so TMA
//     zero-fills rows past S inside each batch instead of reading the next
//     sequence; their 128-byte swizzle is the one the wgmma descriptors name.
//     A D = 128 tile is two 64-column boxes, walked by the K-steps (QK^T) and
//     by the descriptors' leading offset (PV).
//   - O leaves through shared memory: each consumer warpgroup writes its 64
//     rows of O, divided by l, into its rows of the item's Q buffer (read for
//     the last time; the same swizzle) and one of its threads stores them
//     with TMA, which writes nothing past S. The buffer goes back to the
//     loader once the store has read it, after the next item's first QK^T
//     is issued. Direct 4-byte stores from the accumulator layout, half a
//     32-byte sector each, were the slower way out.
//   - Tile skipping: the walkers read the item's batch row of kv_mask and
//     kv_segs and record, per key tile, whether any key may be attended and
//     whether all may (for segments: the tile's [min, max] id over its live
//     keys against the q tile's; ranges that do not overlap cannot match,
//     sorted or not). Tiles with no allowed key, and causal tiles above the
//     diagonal, are never copied nor computed: they would add 0 to l and O
//     and leave m unchanged. Only partly masked tiles and the causal
//     diagonal tile test each element, from four ballot words of the tile's
//     key mask and, per row, causal and segment masks of 32 bits. S is
//     bounded only by the tile lists' 8 bytes per tile of shared memory.
//
// Bound on the card (chip_smoke.py's _bound: q, o, LSE, the masks and the
// K/V rows of keys some q row may attend, once, at 3.35 TB/s against
// 4*D*H*(allowed pairs) at 989 TFLOP/s): at BERT-base (B=32, S=512, H=12,
// D=64) both bytes-bound, served (lengths uniform in 1..512, half the keys
// live) ~76.3 MB in 0.0228 ms against 12.9 GFLOP in 0.0130 ms, trained
// (every key live) ~101.5 MB in 0.0303 ms against 25.8 GFLOP in 0.0261 ms;
// at D = 128 causal GQA (B=2, S=2048, H=32, Hkv=8) operations-bound. In
// practice the consumers bound it at D = 64: per 128 x 128 tile the two
// products, the 16,384 exp2 (16 a clock on an SM) and the softmax's FP32
// work take about the same time, and with S = 512 an item has at most 4 key
// tiles, so its first S and last PV, which nothing overlaps, weigh. Nor are
// the copies free: each head's K/V passes through L2 once for each of its q
// tiles (four at S = 512), and that traffic alone is a large share of the
// kernel's time at BERT's shapes. So the design keeps the copies off the
// critical path (TMA ring, one producer thread) and does the least work: no
// masked tile, no per-element test in a clean tile, the tensor cores at
// their Hopper rate.
//
// What it does about the previous version's costs: (1) synchronous
// register-staged loads and two __syncthreads per tile -> TMA into an
// mbarrier ring, the copy of tile i+1 overlapping the math of tile i;
// (2) mma.sync m16n8k16 -> wgmma.mma_async; (3) fragments packed from scalar
// shared loads -> wgmma reads shared memory through descriptors and P stays
// in registers; (4) 64-row blocks, K/V re-read S/64 times -> 128-row blocks;
// (5) fully masked key tiles computed -> skipped from the masks;
// (6) a mask test per element in every tile -> only in partial and diagonal
// tiles, on bits; (7) a separate scale multiply, a divide per output element
// and a cudaFuncSetAttribute per launch -> scale*log2e folded into one FMA
// before exp2, 1/l once per row, the attribute set once per device.

#include "sm90.cuh"

namespace {

constexpr int kBlockQ = 128;   // q rows per block: two consumer warpgroups
constexpr int kBlockK = 128;   // keys per K/V tile
constexpr int kThreads = 384;  // warpgroups 0, 1 consume; 2 produces
constexpr int kBoxBytes = kBlockK * kBoxCols * 2;  // 16 KB, 128 rows
constexpr float kMaskValue = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kNeedMask = 1 << 30;      // tile-list bit: test each element

template <int D>
struct Cfg {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;  // one Q, K or V tile
  static constexpr int kTilesBytes = kTileBytes * (2 + 2 * kStages);
  // Q full and empty x 2; K full, V full, K empty, V empty x stages; list
  // full and empty x 2
  static constexpr int kBars = 4 + 4 * kStages + 4;
};

// -- the kernel ----------------------------------------------------------------

constexpr int kWalkers = 3;  // warps 9-11 walk the masks; warp 8 loads

// One work item: a (batch*head, 128-row q tile) pair; block i takes items
// i, i + gridDim.x, ... Without causal the items go head by head (a head's
// K/V stays in L2 across its q tiles); with causal the q tiles go from the
// last, the longest, down, all heads at once, so that every block gets
// rows of every length.
struct Item {
  int b, h, hkv, q0, kt_end;
  long row0;  // this batch's row of the [B, S] masks
};

__device__ __forceinline__ Item decode(int item, int n_tiles, int S, int B,
                                       int H, int Hkv, int causal) {
  Item it;
  const int bh = causal ? item % (B * H) : item / n_tiles;
  const int qt = causal ? n_tiles - 1 - item / (B * H) : item % n_tiles;
  it.b = bh / H;
  it.h = bh % H;
  it.hkv = it.h / (H / Hkv);  // GQA: q head h reads kv head h / group
  it.q0 = qt * kBlockQ;
  it.kt_end = causal ? qt + 1 : n_tiles;  // causal: none above the diagonal
  it.row0 = static_cast<long>(it.b) * S;
  return it;
}

__device__ __forceinline__ void walkers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kWalkers * 32) : "memory");
}

// The key tiles of one item that some q row may attend, in order, into
// `list` (the tile index, | kNeedMask when not every key of it may be
// attended by every row), their count into info[2]; then `bar_full`. For
// segments a tile's [min, max] id over its live keys is held against the q
// tile's (info[0], info[1]): ranges that do not overlap cannot match. Run by
// the walker warps (ww = 0, 1, 2) together.
__device__ __forceinline__ void walk_tiles(const Item& it, int S,
                                           const int* kv_mask,
                                           const int* q_segs,
                                           const int* kv_segs, int* info,
                                           int* list, int ww, int lane,
                                           uint32_t bar_full) {
  const bool has_segs = q_segs != nullptr;
  if (has_segs && ww == 0) {
    int mn = INT_MAX, mx = INT_MIN;
    for (int r = it.q0 + lane; r < min(it.q0 + kBlockQ, S); r += 32) {
      const int sg = q_segs[it.row0 + r];
      mn = min(mn, sg);
      mx = max(mx, sg);
    }
    mn = warp_min(mn);
    mx = warp_max(mx);
    if (lane == 0) {
      info[0] = mn;
      info[1] = mx;
    }
  }
  walkers_sync();
  const int qmin = info[0], qmax = info[1];
  for (int t = ww; t < it.kt_end; t += kWalkers) {
    bool all_ok = true, any_ok = false;
    int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
    for (int i = 0; i < kBlockK / 32; ++i) {
      const int key = t * kBlockK + i * 32 + lane;
      const bool ok =
          key < S && (kv_mask == nullptr || kv_mask[it.row0 + key] != 0);
      all_ok = all_ok && ok;
      any_ok = any_ok || ok;
      if (has_segs && ok) {
        const int sg = kv_segs[it.row0 + key];
        mn = min(mn, sg);
        mx = max(mx, sg);
      }
    }
    all_ok = __all_sync(0xffffffffu, all_ok);
    any_ok = __any_sync(0xffffffffu, any_ok);
    if (has_segs) {
      mn = warp_min(mn);
      mx = warp_max(mx);
      any_ok = any_ok && mn <= qmax && mx >= qmin;
      all_ok = all_ok && mn == mx && qmin == qmax && mn == qmin;
    }
    if (lane == 0) list[t] = any_ok ? (t | (all_ok ? 0 : kNeedMask)) : -1;
  }
  walkers_sync();
  if (ww == 0) {  // compact the kept tiles to the front, in order
    int count = 0;
    for (int t0 = 0; t0 < it.kt_end; t0 += 32) {
      const int e = t0 + lane < it.kt_end ? list[t0 + lane] : -1;
      const unsigned keep = __ballot_sync(0xffffffffu, e >= 0);
      if (e >= 0) list[count + __popc(keep & ((1u << lane) - 1u))] = e;
      count += __popc(keep);
      __syncwarp();
    }
    if (lane == 0) {
      info[2] = count;
      mbar_arrive(bar_full);
    }
  }
}

// Which keys of a 128-key tile may be attended, read by each consumer warp
// right after it issues the tile's products (the loads then hide under
// them): key k0 + 32i + b is bit b of word i; `seg` is the live keys' one
// segment id, `mixed` says they have more than one.
struct TileKeys {
  uint32_t w[4];
  int seg;
  bool mixed;
};

__device__ __forceinline__ TileKeys tile_keys(int k0, int S, const int* kv_mask,
                                              const int* kv_segs, long row0,
                                              int lane) {
  TileKeys t;
  int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 32 * i + lane;
    const bool ok = key < S && (kv_mask == nullptr || kv_mask[row0 + key] != 0);
    t.w[i] = __ballot_sync(0xffffffffu, ok);
    if (kv_segs != nullptr && ok) {
      const int sg = kv_segs[row0 + key];
      mn = min(mn, sg);
      mx = max(mx, sg);
    }
  }
  t.seg = 0;
  t.mixed = false;
  if (kv_segs != nullptr) {
    mn = warp_min(mn);
    mx = warp_max(mx);
    t.seg = mn;
    t.mixed = mn != mx;
  }
  return t;
}

// A thread's keys in a tile are k0 + 8jt + 2tig + x (jt < 16, x < 2): bit
// 2jt + x of the row masks below, in increasing key order.
__device__ __forceinline__ uint32_t thread_bits(const uint32_t (&w)[4],
                                                int tig) {
  uint32_t bits = 0;
#pragma unroll
  for (int jt = 0; jt < 16; ++jt)
    bits |= ((w[jt >> 2] >> (8 * (jt & 3) + 2 * tig)) & 3u) << (2 * jt);
  return bits;
}

// Causal: the thread's keys of the tile that are <= row, a prefix of bits.
__device__ __forceinline__ uint32_t causal_bits(int row, int k0, int tig) {
  const int d = row - k0 - 2 * tig;  // key offset 8jt + x must be <= d
  if (d < 0) return 0u;
  const int n = 2 * (d / 8) + min(d % 8, 1) + 1;  // bits with 8jt + x <= d
  return n >= 32 ? ~0u : (1u << n) - 1u;
}

// One key tile of a thread's two rows: s[4j + x] is row r_lo, key
// k0 + 8j + 2tig + x; s[4j + 2 + x] is row r_lo + 8. Masks the tile when
// kTest (keys from tile_keys, then causal and segment ids), folds it into
// the running max m (raw logits) and sum l, and writes p = exp2(s*c - m*c),
// exactly 0 under the mask, to pf; corr_* rescale O to the new max. s is
// only read: it holds a wgmma's registers while PV(i-1) runs, and writing
// them then would make ptxas serialize every wgmma.
template <bool kTest>
__device__ __forceinline__ void softmax_tile(
    const float (&s)[64], float (&pf)[64], const TileKeys& keys, int k0,
    const int* kv_segs, long row0, int causal, int tig, int r_lo, int seg_lo,
    int seg_hi, float c, float& m_lo, float& m_hi, float& l_lo, float& l_hi,
    float& corr_lo, float& corr_hi) {
  uint32_t ok_lo = ~0u, ok_hi = ~0u;  // bit 2jt + x: key of s[4jt + x]
  if (kTest) {
    ok_lo = ok_hi = thread_bits(keys.w, tig);
    if (causal) {
      ok_lo &= causal_bits(r_lo, k0, tig);
      ok_hi &= causal_bits(r_lo + 8, k0, tig);
    }
    if (keys.mixed) {  // rare: a document boundary inside the tile
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const int key = k0 + 8 * (b >> 1) + 2 * tig + (b & 1);
        if ((ok_lo | ok_hi) >> b & 1u) {
          const int sg = kv_segs[row0 + key];
          if (sg != seg_lo) ok_lo &= ~(1u << b);
          if (sg != seg_hi) ok_hi &= ~(1u << b);
        }
      }
    } else if (kv_segs != nullptr) {
      if (seg_lo != keys.seg) ok_lo = 0;
      if (seg_hi != keys.seg) ok_hi = 0;
    }
  }
  auto ok = [&](int j) {
    return !kTest ||
           ((((j & 2) ? ok_hi : ok_lo) >> (2 * (j >> 2) + (j & 1))) & 1u);
  };
  float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const float x = ok(j) ? s[j] : kMaskValue;
    if ((j & 2) == 0) mx_lo = fmaxf(mx_lo, x); else mx_hi = fmaxf(mx_hi, x);
  }
  mx_lo = quad_max(mx_lo);
  mx_hi = quad_max(mx_hi);
  corr_lo = ex2((m_lo - mx_lo) * c);
  corr_hi = ex2((m_hi - mx_hi) * c);
  m_lo = mx_lo;
  m_hi = mx_hi;
  const float mc_lo = mx_lo * c, mc_hi = mx_hi * c;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const bool lo = (j & 2) == 0;
    const float p = ok(j) ? ex2(fmaf(s[j], c, -(lo ? mc_lo : mc_hi))) : 0.f;
    pf[j] = p;
    if (lo) sum_lo += p; else sum_hi += p;
  }
  l_lo = l_lo * corr_lo + sum_lo;
  l_hi = l_hi * corr_hi + sum_hi;
}

// S = Q K^T for one warpgroup's 64 rows: D/16 K-steps of 16 columns, 32
// bytes each inside a swizzled 128-byte row; a D = 128 tile's second box
// holds columns 64-127. Both operands K-major.
template <int D>
__device__ __forceinline__ void qk_descs(uint64_t (&dq)[D / 16],
                                         uint64_t (&dk)[D / 16],
                                         uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t off = (ks / 4) * kBoxBytes + (ks % 4) * 32;
    dq[ks] = smem_desc(q_addr + off, 16, 8 * kRowBytes);
    dk[ks] = smem_desc(k_addr + off, 16, 8 * kRowBytes);
  }
  pin(dq);
  pin(dk);
}

// O += P V: V [keys, D] is the MN-major B operand, 8 keys a 1024-byte
// swizzle atom (stride offset), 64 columns a box (leading offset); K-step kk
// takes keys 16kk..16kk+15.
__device__ __forceinline__ void pv_descs(uint64_t (&dv)[8], uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    dv[kk] = smem_desc(v_addr + kk * 16 * kRowBytes, kBoxBytes, 8 * kRowBytes);
  pin(dv);
}

template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64],
                                         const uint64_t (&dq)[D / 16],
                                         const uint64_t (&dk)[D / 16],
                                         uint32_t zero, uint32_t one) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_ss_n128(s, dq[ks], dk[ks], ks > 0 ? one : zero);
}

// P's K-step kk is S's n-tiles 2kk and 2kk+1, already in the A layout.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&p)[32],
                                         const uint64_t (&dv)[8],
                                         uint32_t one) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_rs(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
             dv[kk], one);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o,
                 const int* __restrict__ kv_mask,
                 const int* __restrict__ q_segs,
                 const int* __restrict__ kv_segs,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int B, int S, int H, int Hkv, float scale, int causal) {
  using C = Cfg<D>;
  constexpr int NS = C::kStages;

  // Shared memory (1024-byte aligned, as the 128-byte swizzle wants): two Q
  // buffers, the K ring, the V ring, the barriers, then per list buffer
  // {q seg min, max, tile count, pad} and the two tile lists.
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sK = sQ + 2 * C::kTileBytes;
  const uint32_t sV = sK + NS * C::kTileBytes;
  const uint32_t bar0 = base + C::kTilesBytes;
  auto barQF = [&](int qb) { return bar0 + 8u * qb; };       // Q copied
  auto barQE = [&](int qb) { return bar0 + 8u * (2 + qb); }; // Q read
  auto barK = [&](int st) { return bar0 + 8u * (4 + st); };
  auto barV = [&](int st) { return bar0 + 8u * (4 + NS + st); };
  // a stage's K and its V are released apart: K once S = QK^T is done
  auto barEK = [&](int st) { return bar0 + 8u * (4 + 2 * NS + st); };
  auto barEV = [&](int st) { return bar0 + 8u * (4 + 3 * NS + st); };
  auto barLF = [&](int lb) { return bar0 + 8u * (4 + 4 * NS + lb); };
  auto barLE = [&](int lb) { return bar0 + 8u * (6 + 4 * NS + lb); };
  int* sInfo = reinterpret_cast<int*>(smem + C::kTilesBytes + 8 * C::kBars);
  const int n_tiles = (S + kBlockQ - 1) / kBlockQ;  // q tiles = key tiles
  int* sList = sInfo + 8;                           // [2][n_tiles]
  const int n_items = B * H * n_tiles;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(barQF(qb), 1);
      mbar_init(barQE(qb), 2);  // once O's store has read it, per warpgroup
    }
    for (int st = 0; st < NS; ++st) {
      mbar_init(barK(st), 1);
      mbar_init(barV(st), 1);
      mbar_init(barEK(st), 2 * 128);
      mbar_init(barEV(st), 2 * 128);
    }
    for (int lb = 0; lb < 2; ++lb) {
      mbar_init(barLF(lb), 1);
      mbar_init(barLE(lb), 2 * 128 + 1);  // the consumers and the loader
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Persistent: the walkers list the block's next item while the current one
  // runs. The n-th item's tile list goes into list buffer n % 2, its Q into
  // Q buffer (items with tiles so far) % 2; K/V tiles turn the ring in one
  // sequence across items.
  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8) {
      // ---- loader: one thread keeps Q and the ring filled ----
      if (lane == 0) {
        int nq = 0, tc = 0;
        for (int n = 0, item = blockIdx.x; item < n_items;
             ++n, item += gridDim.x) {
          const int lb = n & 1;
          mbar_wait(barLF(lb), (n >> 1) & 1);
          const int count = sInfo[4 * lb + 2];
          const int* list = sList + lb * n_tiles;
          if (count > 0) {
            const Item it = decode(item, n_tiles, S, B, H, Hkv, causal);
            const int qb = nq & 1;
            mbar_wait(barQE(qb), ((nq >> 1) & 1) ^ 1);  // first turn: free
            mbar_expect_tx(barQF(qb), C::kTileBytes);
#pragma unroll
            for (int box = 0; box < C::kBoxes; ++box)
              tma_load(sQ + qb * C::kTileBytes + box * kBoxBytes, &tm_q,
                       barQF(qb), box * kBoxCols, it.h, it.q0, it.b);
            ++nq;
            for (int i = 0; i < count; ++i, ++tc) {
              const int k0 = (list[i] & (kNeedMask - 1)) * kBlockK;
              const int st = tc % NS;
              const uint32_t free_par = ((tc / NS) & 1) ^ 1;  // first turn: free
              mbar_wait(barEK(st), free_par);
              mbar_expect_tx(barK(st), C::kTileBytes);
#pragma unroll
              for (int box = 0; box < C::kBoxes; ++box)
                tma_load(sK + st * C::kTileBytes + box * kBoxBytes, &tm_k,
                         barK(st), box * kBoxCols, it.hkv, k0, it.b);
              mbar_wait(barEV(st), free_par);
              mbar_expect_tx(barV(st), C::kTileBytes);
#pragma unroll
              for (int box = 0; box < C::kBoxes; ++box)
                tma_load(sV + st * C::kTileBytes + box * kBoxBytes, &tm_v,
                         barV(st), box * kBoxCols, it.hkv, k0, it.b);
            }
          }
          mbar_arrive(barLE(lb));
        }
      }
    } else {
      // ---- walkers: the next items' tile lists, ahead of the consumers ----
      for (int n = 0, item = blockIdx.x; item < n_items;
           ++n, item += gridDim.x) {
        const int lb = n & 1;
        mbar_wait(barLE(lb), ((n >> 1) & 1) ^ 1);  // first turn: free
        walk_tiles(decode(item, n_tiles, S, B, H, Hkv, causal), S, kv_mask,
                   q_segs, kv_segs, sInfo + 4 * lb, sList + lb * n_tiles,
                   warp - 9, lane, barLF(lb));
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows [64 wg, 64 wg + 64) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // broadcast, so that the compiler sees it warp-uniform and keeps the
    // descriptors in uniform registers
    const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);
    const int g = lane >> 2, tig = lane & 3;  // accumulator fragment coordinates
    const float c = scale * kLog2e;  // exp(scale*(s - m)) = exp2(s*c - m*c)
    uint32_t p[32];
    float acc[D / 2];
    // the wgmma scale-d flags, as registers defined before any stage opens
    uint32_t zero = 0, one = 1;
    asm volatile("" : "+r"(zero), "+r"(one));
    int nq = 0, tc = 0;
    // one thread a warpgroup stores O; the Q buffer that holds the last O
    // stored is released once the store has read it
    const bool storer = warp % 4 == 0 && lane == 0;
    int o_buf = -1;
    for (int n = 0, item = blockIdx.x; item < n_items; ++n, item += gridDim.x) {
      const int lb = n & 1;
      mbar_wait(barLF(lb), (n >> 1) & 1);
      const Item it = decode(item, n_tiles, S, B, H, Hkv, causal);
      const int wg_q0 = it.q0 + wg * 64;
      const int r_lo = wg_q0 + (warp % 4) * 16 + g, r_hi = r_lo + 8;
      const int seg_lo = q_segs != nullptr && r_lo < S ? q_segs[it.row0 + r_lo] : 0;
      const int seg_hi = q_segs != nullptr && r_hi < S ? q_segs[it.row0 + r_hi] : 0;
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
      float m_lo = kMaskValue, m_hi = kMaskValue;  // running max, raw logits
      float l_lo = 0.f, l_hi = 0.f;  // this thread's share of the row sums
      const int count = sInfo[4 * lb + 2];
      const int* list = sList + lb * n_tiles;
      const int qb = nq & 1;
      if (count > 0) {
        const uint32_t q_addr = sQ + qb * C::kTileBytes + wg * 64 * kRowBytes;
        // The softmax of one tile, p into pf; the element test only where
        // the tile list or the causal diagonal asks for it
        float pf[64], corr_lo, corr_hi;
        TileKeys keys;
        bool test = false;
        // issued with a tile's products: whether it needs the element test,
        // and if so its keys
        auto read_keys = [&](int e) {
          const int k0 = (e & (kNeedMask - 1)) * kBlockK;
          test = (e & kNeedMask) || (causal && k0 + kBlockK - 1 > wg_q0);
          if (test) keys = tile_keys(k0, S, kv_mask, kv_segs, it.row0, lane);
        };
        auto softmax = [&](const float (&sv)[64], int e) {
          const int k0 = (e & (kNeedMask - 1)) * kBlockK;
          if (test)
            softmax_tile<true>(sv, pf, keys, k0, kv_segs, it.row0, causal,
                               tig, r_lo, seg_lo, seg_hi, c, m_lo, m_hi, l_lo,
                               l_hi, corr_lo, corr_hi);
          else
            softmax_tile<false>(sv, pf, keys, k0, kv_segs, it.row0, causal,
                                tig, r_lo, seg_lo, seg_hi, c, m_lo, m_hi,
                                l_lo, l_hi, corr_lo, corr_hi);
        };
        int st = tc % NS;
        uint32_t par = (tc / NS) & 1;
        mbar_wait(barQF(qb), (nq >> 1) & 1);
        {  // tile 0: S and its softmax; nothing to overlap yet
          float s[64];
          uint64_t dq[D / 16], dk[D / 16];
          qk_descs<D>(dq, dk, q_addr, sK + st * C::kTileBytes);
          mbar_wait(barK(st), par);
          wgmma_fence();
          issue_qk<D>(s, dq, dk, zero, one);
          wgmma_commit();
          if (o_buf >= 0 && storer) {  // the previous O's buffer, for a next Q
            bulk_wait_read();
            mbar_arrive(barQE(o_buf));
          }
          o_buf = -1;
          read_keys(list[0]);
          wgmma_wait<0>();
          pin(s);
          mbar_arrive(barEK(st));  // this stage's K is read
          softmax(s, list[0]);
        }
#pragma unroll
        for (int j = 0; j < 32; ++j) p[j] = pack_bf16(pf[2 * j], pf[2 * j + 1]);
        // Tile i's QK^T and tile i-1's PV are issued together; tile i's
        // softmax runs while PV(i-1) is on the tensor cores
        for (int i = 1; i < count; ++i) {
          const int st_prev = st;
          const uint32_t par_prev = par;
          st = (tc + i) % NS;
          par = ((tc + i) / NS) & 1;
          float s[64];  // a fresh S each tile: its first K-step overwrites
          uint64_t dq[D / 16], dk[D / 16], dv[8];
          qk_descs<D>(dq, dk, q_addr, sK + st * C::kTileBytes);
          pv_descs(dv, sV + st_prev * C::kTileBytes);
          mbar_wait(barK(st), par);
          mbar_wait(barV(st_prev), par_prev);
          pin(acc);
          pin(p);
          wgmma_fence();
          issue_qk<D>(s, dq, dk, zero, one);
          wgmma_commit();
          issue_pv<D>(acc, p, dv, one);
          wgmma_commit();
          const int e = list[i];
          read_keys(e);
          wgmma_wait<1>();
          pin(s);
          mbar_arrive(barEK(st));
          softmax(s, e);
          wgmma_wait<0>();
          pin(acc);
          pin(p);
          mbar_arrive(barEV(st_prev));  // tile i-1's V is read
          // P's conversion defines the next PV's A registers: keep it after
          // the wait, or ptxas serializes the wgmmas
          pin(pf);
#pragma unroll
          for (int dt = 0; dt < D / 8; ++dt) {
            acc[4 * dt] *= corr_lo;
            acc[4 * dt + 1] *= corr_lo;
            acc[4 * dt + 2] *= corr_hi;
            acc[4 * dt + 3] *= corr_hi;
          }
#pragma unroll
          for (int j = 0; j < 32; ++j) p[j] = pack_bf16(pf[2 * j], pf[2 * j + 1]);
        }
        {  // the last tile's PV
          uint64_t dv[8];
          pv_descs(dv, sV + st * C::kTileBytes);
          mbar_wait(barV(st), par);
          pin(acc);
          pin(p);
          wgmma_fence();
          issue_pv<D>(acc, p, dv, one);
          wgmma_commit();
          wgmma_wait<0>();
          pin(acc);
          pin(p);
          mbar_arrive(barEV(st));
        }
        tc += count;
      }
      mbar_arrive(barLE(lb));

      // O = acc / l, LSE = m*scale + log(l); a row with no allowed key has
      // l = 0, acc = 0: O = 0, LSE = -1e30
      l_lo = quad_sum(l_lo);
      l_hi = quad_sum(l_hi);
      const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;
      const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
      if (count > 0) {
        // O into this item's Q rows of the warpgroup (read for the last time;
        // 128-byte swizzle, as the map's), then one TMA store of 64 rows
        const uint32_t o_smem = sQ + qb * C::kTileBytes + wg * 64 * kRowBytes;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = (warp % 4) * 16 + g + 8 * hf;
            const float inv = hf ? inv_hi : inv_lo;
            const uint32_t addr = o_smem + (dt / 8) * kBoxBytes + row * kRowBytes +
                                  (((dt % 8) ^ (row & 7)) * 16) + tig * 4;
            asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr),
                         "r"(pack_bf16(acc[4 * dt + 2 * hf] * inv,
                                       acc[4 * dt + 2 * hf + 1] * inv))
                         : "memory");
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
        if (storer) {
#pragma unroll
          for (int box = 0; box < C::kBoxes; ++box)
            tma_store(&tm_o, o_smem + box * kBoxBytes, box * kBoxCols, it.h,
                      wg_q0, it.b);
          bulk_commit();
        }
        o_buf = qb;
        ++nq;
      } else {  // no key to attend: O = 0
        const long q_stride = static_cast<long>(H) * D;
        __nv_bfloat16* o_lo =
            o + (it.row0 + r_lo) * q_stride + static_cast<long>(it.h) * D;
        __nv_bfloat16* o_hi = o_lo + 8 * q_stride;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          const int col = dt * 8 + tig * 2;
          if (r_lo < S)
            *reinterpret_cast<uint32_t*>(o_lo + col) = 0u;
          if (r_hi < S)
            *reinterpret_cast<uint32_t*>(o_hi + col) = 0u;
        }
      }
      if (tig == 0) {
        const long lrow = (static_cast<long>(it.b) * H + it.h) * S;
        if (r_lo < S)
          lse[lrow + r_lo] = l_lo > 0.f ? m_lo * scale + logf(l_lo) : kMaskValue;
        if (r_hi < S)
          lse[lrow + r_hi] = l_hi > 0.f ? m_hi * scale + logf(l_hi) : kMaskValue;
      }
    }
    if (storer) bulk_wait();  // O's last stores, before the block ends
  }
}

// -- host side -----------------------------------------------------------------

template <int D>
int launch(const void* q, const void* k, const void* v, const void* kv_mask,
           const void* q_segs, const void* kv_segs, void* o, void* lse, int B,
           int S, int H, int Hkv, float scale, int causal,
           cudaStream_t stream) {
  using C = Cfg<D>;
  static bool configured[kMaxDevices] = {};
  static int sm_count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {  // once per device, not per launch
    err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sm_count[dev],
                                   cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const int n_tiles = (S + kBlockQ - 1) / kBlockQ;
  // alignment slack, tiles, barriers, two {info} and two tile lists
  const size_t smem = 1024 + C::kTilesBytes + 8 * C::kBars + 32 +
                      8 * (size_t)n_tiles;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!make_map(&tm_q, q, B, S, H, D, kBlockQ) ||
      !make_map(&tm_k, k, B, S, Hkv, D, kBlockK) ||
      !make_map(&tm_v, v, B, S, Hkv, D, kBlockK) ||
      !make_map(&tm_o, o, B, S, H, D, kBlockQ / 2))
    return (int)cudaErrorNotSupported;
  // persistent: one block an SM
  const long items = (long)B * H * n_tiles;
  const int blocks = (int)(items < sm_count[dev] ? items : sm_count[dev]);
  flash_fwd_kernel<D><<<blocks, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_o, static_cast<const int*>(kv_mask),
      static_cast<const int*>(q_segs), static_cast<const int*>(kv_segs),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), B, S, H, Hkv,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). q, o: [B, S, H, D] bf16; k, v:
// [B, S, Hkv, D] bf16; kv_mask, q_segs, kv_segs: [B, S] int32 or null (segs
// both or neither); lse: [B*H, S] f32. All contiguous, 16-byte aligned.
// Returns the CUDA error code of the launch (0 = launched).
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

// The CUDA runtime version the library was built against (CUDART_VERSION).
extern "C" int dls_flash_fwd_cuda_version() { return CUDART_VERSION; }
