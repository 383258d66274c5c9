// FlashAttention-2 backward for Hopper (sm_90a): bf16 in, f32 accumulation.
//
// Two kernels, each with its own C entry point. They replace the Pallas
// kernels driven by `_flash_bwd` in
// distributeddeeplearningspark_tpu/ops/flash_attention.py: K2,
// flash_bwd_dq_kernel, replaces `_bwd_dq_kernel`; K3, flash_bwd_dkv_kernel,
// replaces `_bwd_dkv_kernel`. They compute what those compute, not their
// block structure: the TPU grids carry their accumulators across a
// sequential grid axis, and here a loop inside each block takes its place.
//
// Contract: q, dO [B, S, H, D] and k, v [B, S, Hkv, D] bf16, D 64 or 128,
// any S >= 1; LSE (from K1) and delta = rowsum(dO*O) (from `_delta`) plain
// [B*H, S] f32; a key-only kv_mask and q_segs/kv_segs [B, S] int32; causal
// or not. P = exp(scale*QK^T - LSE) is zeroed by the mask bits, never
// through the exponent (a fully masked row has LSE = -1e30, where the
// exponent would give 1); dS = P*(dP - delta), dP = dO V^T; dQ = scale*dS K,
// dV = P^T dO, dK = scale*dS^T Q; a kv head's dK and dV are summed over its
// GQA group without repeating K/V. P and dS are rounded to bf16 as product
// operands. Rows that see no key get dQ = 0, keys that no row may attend
// dK = dV = 0.
//
// Two kernels and no atomics, so the gradients are deterministic. A merged
// kernel (FlashAttention-3's) runs 5 products where these run 7 (S and dP
// in both), but adds dQ by f32 atomics into a scratch buffer that a third
// pass converts: the sum's order then changes from run to run, the entry
// points change, and one TPU kernel no longer maps to one kernel here. At
// BERT's training shape (B=32, S=512, H=12, D=64, every key allowed) the
// operations bound is 3 products for K2 (0.0391 ms at 989 TFLOP/s) and 4
// for K3 (0.0521 ms), 7/5 x the merged kernel's 0.0651 ms = 0.091 ms for
// the pair; the bytes (q, k, v, dO, the gradients, LSE and delta once,
// ~0.06 ms at 3.35 TB/s) weigh less. In practice the products bound them
// too, well below the tensor cores' rate: in timing-only builds of K2 (not
// kept), dropping the K/V copies changed nothing, and dropping the exp2 and
// FP32 work as well left most of the kernel's time.
//
// Design: both kernels take K1's shape. A persistent grid, one block of
// three warpgroups on each SM, each block walking its share of the items.
//   - Warpgroup 2 gives up registers (setmaxnreg 40). Its warps 9-11 walk
//     the next item's masks while the current one runs and list the tiles
//     that some pair may attend; warp 8 loads: one thread issues TMA copies
//     (rank-4 tensor maps [B, S, heads, D], 128-byte swizzle, rows past S
//     zero-filled inside each batch), its 32 lanes copy the LSE*log2e and
//     delta slices (and K3's q segment ids) with plain loads into shared
//     memory beside the tiles, since a [B*H, S] f32 row is not 16-byte
//     aligned for every S.
//   - Warpgroups 0 and 1 consume (setmaxnreg 232), 64 rows each.
//   - K2, an item = (b*h, 128-row q tile): Q and dO are copied once per item
//     (two buffers, so the next item's arrive during this one), K and V
//     tiles (128 keys at D = 64, 64 at D = 128) through a ring of stages with
//     a full and an empty mbarrier each for K and for V. S = Q K^T and
//     dP = dO V^T are wgmma m64nNk16 with both operands in shared memory,
//     K-major; V is released once dP is done. P and dS are formed in
//     registers (scale*log2e folded into one FMA before exp2) and packed to
//     bf16 in the accumulator's fragment layout, which is the A operand's;
//     dQ += dS K is a wgmma with dS in registers and K read MN-major through
//     the transpose bit; then K is released. scale*dQ leaves through the
//     item's Q buffer and a TMA store.
//   - K3, an item = (b*hkv, 128-key tile): K and V are copied once per item
//     (two buffers); the ring carries (group head, q tile) stages of Q and
//     dO (128 rows at D = 64, 64 at D = 128) with their LSE, delta and
//     segment-id slices. S^T = K Q^T and dP^T = V dO^T from shared memory;
//     P^T and dS^T in registers against the per-column LSE and delta;
//     dV += P^T dO and dK += dS^T Q with dO and Q read MN-major. The ring
//     walks every q head of the kv head's group in turn, dK and dV staying
//     in f32 registers; they leave through the item's K and V buffers and
//     TMA stores.
//   - The partner tile is 64 wide at D = 128 so that a consumer thread holds
//     S and dP (32 f32 each) beside dQ (64), or S^T and dP^T beside dK and
//     dV (64 each). ptxas reports small K3 spills (about 160 bytes at
//     D = 64, 64 at D = 128), in the producer warpgroup's 40 registers;
//     K2 has none.
//   - K3's two consumer warpgroups take turns to issue their products
//     (named barriers), so that one's exp2 and FP32 work overlaps the
//     other's products. K2 runs without turns: with them it measured no
//     faster. Each warpgroup waits for a tile's products before it issues
//     the next ones: issuing tile i+1's S and dP together with tile i's dQ
//     (one wait a tile) measured slower.
//   - Every wgmma input is defined before the wgmma.fence that opens its
//     stage and nothing writes one while a stage is open, or ptxas
//     serializes every wgmma of the kernel (C7513/C7520).
//   - Tile skipping: K2 never copies nor computes a key tile in which no key
//     may be attended by its q tile (padding, segment [min, max] ranges that
//     do not overlap, causal above the diagonal); K3 never copies a q tile
//     that cannot see its key tile. An item with nothing to compute still
//     writes its zeros. Only partly masked and causal diagonal tiles test
//     each element; at BERT's training shape every tile is clean.
//
// What it does about the previous (mma.sync) version's costs: (1) loads
// through registers behind two __syncthreads per tile -> TMA into mbarrier
// rings, the copy of the next tile overlapping the math of this one;
// (2) mma.sync m16n8k16 -> wgmma.mma_async; (3) fragments packed from scalar
// shared loads and re-read per product -> descriptors for shared operands,
// P and dS kept in registers as A operands; (4) 64-row blocks re-reading
// K/V (K2) or Q/dO (K3) S/64 times -> 128-row items; (5) only causal tiles
// skipped -> tiles skipped from the masks as K1 does; (6) a mask test per
// element in every tile -> only in partial and diagonal tiles, on bits;
// (7) cudaFuncSetAttribute on every launch -> once per device and kernel.

#include "sm90.cuh"

namespace {

constexpr int kThreads = 384;  // warpgroups 0, 1 consume; 2 produces
constexpr int kItemRows = 128; // K2: q rows of an item; K3: its keys
constexpr int kWalkers = 3;    // warps 9-11 walk the masks; warp 8 loads
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kNeedMask = 1 << 30;  // tile-list bit: test each element

// A [ROWS, D] bf16 tile in shared memory: D/64 swizzled boxes of ROWS rows.
template <int D, int ROWS>
struct Tile {
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kBoxBytes = ROWS * kRowBytes;
  static constexpr int kBytes = kBoxes * kBoxBytes;
};

// K-step ks (16 columns of D) of a K-major operand whose first row is at
// `addr`: 32 bytes a step inside a swizzled 128-byte row, the second box of
// a D = 128 tile holding columns 64-127.
template <int BOX_BYTES>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, int ks) {
  return smem_desc(addr + (ks / 4) * BOX_BYTES + (ks % 4) * 32, 16,
                   8 * kRowBytes);
}

// K-step kk (rows 16kk..16kk+15) of an MN-major B operand [rows, D], D the
// N dimension: 8 rows a 1024-byte swizzle atom (stride offset), 64 columns
// a box (leading offset).
template <int BOX_BYTES>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr, int kk) {
  return smem_desc(addr + kk * 16 * kRowBytes, BOX_BYTES, 8 * kRowBytes);
}

// acc[N/2] = A B^T over D: both operands K-major in shared memory.
template <int D, int N>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2],
                                         const uint64_t (&da)[D / 16],
                                         const uint64_t (&db)[D / 16],
                                         uint32_t zero, uint32_t one) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    if constexpr (N == 128)
      wgmma_ss_n128(acc, da[ks], db[ks], ks > 0 ? one : zero);
    else
      wgmma_ss_n64(acc, da[ks], db[ks], ks > 0 ? one : zero);
  }
}

// acc[D/2] += A B over KS K-steps: A packed bf16 in registers (K-step kk is
// the score accumulator's n-tiles 2kk and 2kk+1, already in the A layout),
// B MN-major in shared memory.
template <int KS, int N>
__device__ __forceinline__ void issue_rs(float (&acc)[N],
                                         const uint32_t (&a)[4 * KS],
                                         const uint64_t (&db)[KS],
                                         uint32_t one) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_rs(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
             db[kk], one);
}

__device__ __forceinline__ void walkers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kWalkers * 32) : "memory");
}

// K3's two consumer warpgroups take turns to issue their products (named
// barriers 4 and 5), so that one's exp2 and FP32 work runs while the
// other's products are on the tensor cores rather than both in step.
// Warpgroup 1 passes the first turn to warpgroup 0 and warpgroup 0 takes
// the last pass back at the end, so no arrival is left pending.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(4 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(5 - wg) : "memory");
}

// Compact the kept entries (>= 0) of list[0, n) to its front, in order;
// their count into *count, then `bar_full`. One warp.
__device__ __forceinline__ void compact_list(int* list, int n, int* count,
                                             int lane, uint32_t bar_full) {
  int kept = 0;
  for (int t0 = 0; t0 < n; t0 += 32) {
    const int e = t0 + lane < n ? list[t0 + lane] : -1;
    const unsigned keep = __ballot_sync(0xffffffffu, e >= 0);
    __syncwarp();
    if (e >= 0) list[kept + __popc(keep & ((1u << lane) - 1u))] = e;
    kept += __popc(keep);
    __syncwarp();
  }
  if (lane == 0) {
    *count = kept;
    mbar_arrive(bar_full);
  }
}

// [min, max] of the ids of rows [r0, r1) (K2: its q tile; K3: a q tile),
// over one warp.
__device__ __forceinline__ void seg_range(const int* segs, long row0, int r0,
                                          int r1, int lane, int& mn, int& mx) {
  mn = INT_MAX;
  mx = INT_MIN;
  for (int r = r0 + lane; r < r1; r += 32) {
    const int sg = segs[row0 + r];
    mn = min(mn, sg);
    mx = max(mx, sg);
  }
  mn = warp_min(mn);
  mx = warp_max(mx);
}

// Which of N keys from k0 may be attended: key k0 + 32i + b is bit b of
// word i; their [min, max] segment id when there are segments; one warp.
template <int N>
struct KeyTile {
  uint32_t w[N / 32];
  int mn, mx;
};

template <int N>
__device__ __forceinline__ KeyTile<N> key_tile(int k0, int S, const int* kv_mask,
                                               const int* kv_segs, long row0,
                                               int lane) {
  KeyTile<N> t;
  int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
  for (int i = 0; i < N / 32; ++i) {
    const int key = k0 + 32 * i + lane;
    const bool ok = key < S && (kv_mask == nullptr || kv_mask[row0 + key] != 0);
    t.w[i] = __ballot_sync(0xffffffffu, ok);
    if (kv_segs != nullptr && ok) {
      const int sg = kv_segs[row0 + key];
      mn = min(mn, sg);
      mx = max(mx, sg);
    }
  }
  t.mn = warp_min(mn);
  t.mx = warp_max(mx);
  return t;
}

// A thread's columns of an accumulator tile are c0 + 8jt + 2tig + x (x < 2):
// bit 2jt + x of the row masks below, in increasing column order. For
// element j of the accumulator (d[4jt + 2hf + x], row half hf) the bit is
// 2(j >> 2) + (j & 1) of the half's mask.
__device__ __forceinline__ bool bit_ok(uint32_t ok_lo, uint32_t ok_hi, int j) {
  return (((j & 2) ? ok_hi : ok_lo) >> (2 * (j >> 2) + (j & 1))) & 1u;
}

// The thread's keys of a key tile from its ballot words (NT n-tiles).
template <int NT>
__device__ __forceinline__ uint32_t thread_bits(const uint32_t (&w)[NT / 4],
                                                int tig) {
  uint32_t bits = 0;
#pragma unroll
  for (int jt = 0; jt < NT; ++jt)
    bits |= ((w[jt >> 2] >> (8 * (jt & 3) + 2 * tig)) & 3u) << (2 * jt);
  return bits;
}

// The thread's columns c0 + 8jt + 2tig + x that are <= row: a prefix of bits.
__device__ __forceinline__ uint32_t prefix_bits(int row, int c0, int tig) {
  const int d = row - c0 - 2 * tig;  // column offset 8jt + x must be <= d
  if (d < 0) return 0u;
  const int n = 2 * (d / 8) + min(d % 8, 1) + 1;
  return n >= 32 ? ~0u : (1u << n) - 1u;
}

// -- K2: dQ --------------------------------------------------------------------

template <int D>
struct DqCfg {
  static constexpr int kBlockN = D == 64 ? 128 : 64;  // keys per K/V tile
  static constexpr int kStages = D == 64 ? 3 : 2;
  using TQ = Tile<D, kItemRows>;  // Q or dO of an item
  using TK = Tile<D, kBlockN>;    // K or V of a stage
  static constexpr int kQBytes = 2 * TQ::kBytes;  // Q then dO
  static constexpr int kTilesBytes = 2 * kQBytes + 2 * kStages * TK::kBytes;
  // Q full and empty x 2; K full, V full, K empty, V empty x stages; list
  // full and empty x 2
  static constexpr int kBars = 8 + 4 * kStages;
  static constexpr int kRowsBytes = 2 * 2 * kItemRows * 4;  // LSE*log2e, delta
};

// A K2 item: a (batch*head, 128-row q tile) pair; block i takes items
// i, i + gridDim.x, ... Without causal the items go head by head (a head's
// K/V stays in L2 across its q tiles); with causal the q tiles go from the
// last, the longest, down, all heads at once.
struct DqItem {
  int b, h, hkv, q0, kt_end;
  long row0;  // this batch's row of the [B, S] masks
};

template <int BN>
__device__ __forceinline__ DqItem decode_dq(int item, int n_qt, int S, int B,
                                            int H, int Hkv, int causal) {
  DqItem it;
  const int bh = causal ? item % (B * H) : item / n_qt;
  const int qt = causal ? n_qt - 1 - item / (B * H) : item % n_qt;
  it.b = bh / H;
  it.h = bh % H;
  it.hkv = it.h / (H / Hkv);
  it.q0 = qt * kItemRows;
  const int n_kt = (S + BN - 1) / BN;
  // causal: no key tile whose first key is past the q tile's last row
  it.kt_end = causal ? min(n_kt, (it.q0 + kItemRows - 1) / BN + 1) : n_kt;
  it.row0 = static_cast<long>(it.b) * S;
  return it;
}

// The key tiles of one K2 item that some q row may attend, in order, into
// `list` (the tile index, | kNeedMask when not every key of it may be
// attended by every row), their count into info[2]; then `bar_full`. For
// segments a tile's [min, max] id over its live keys is held against the q
// tile's: ranges that do not overlap cannot match. Run by the three walker
// warps together (ww = 0, 1, 2).
template <int BN>
__device__ __forceinline__ void walk_dq(const DqItem& it, int S,
                                        const int* kv_mask, const int* q_segs,
                                        const int* kv_segs, int* info,
                                        int* list, int ww, int lane,
                                        uint32_t bar_full) {
  const bool has_segs = q_segs != nullptr;
  if (has_segs && ww == 0) {
    int mn, mx;
    seg_range(q_segs, it.row0, it.q0, min(it.q0 + kItemRows, S), lane, mn, mx);
    if (lane == 0) {
      info[0] = mn;
      info[1] = mx;
    }
  }
  walkers_sync();
  const int qmin = info[0], qmax = info[1];
  for (int t = ww; t < it.kt_end; t += kWalkers) {
    const KeyTile<BN> kt =
        key_tile<BN>(t * BN, S, kv_mask, kv_segs, it.row0, lane);
    bool any_ok = false, all_ok = true;
#pragma unroll
    for (int i = 0; i < BN / 32; ++i) {
      any_ok = any_ok || kt.w[i] != 0u;
      all_ok = all_ok && kt.w[i] == ~0u;
    }
    if (has_segs) {
      any_ok = any_ok && kt.mn <= qmax && kt.mx >= qmin;
      all_ok = all_ok && kt.mn == kt.mx && qmin == qmax && kt.mn == qmin;
    }
    if (lane == 0) list[t] = any_ok ? (t | (all_ok ? 0 : kNeedMask)) : -1;
  }
  walkers_sync();
  if (ww == 0) compact_list(list, it.kt_end, info + 2, lane, bar_full);
}

// The (row, key) pairs of a key tile that a thread's two rows may attend,
// as bits (see bit_ok): the keys' ballot words, then causal, then segments.
template <int BN>
__device__ __forceinline__ void dq_tile_bits(
    const KeyTile<BN>& kt, int k0, const int* kv_segs, long row0, int causal,
    int tig, int r_lo, int seg_lo, int seg_hi, uint32_t& ok_lo,
    uint32_t& ok_hi) {
  ok_lo = ok_hi = thread_bits<BN / 8>(kt.w, tig);
  if (causal) {
    ok_lo &= prefix_bits(r_lo, k0, tig);
    ok_hi &= prefix_bits(r_lo + 8, k0, tig);
  }
  if (kv_segs == nullptr) return;
  if (kt.mn != kt.mx) {  // rare: a document boundary inside the tile
#pragma unroll
    for (int b = 0; b < BN / 4; ++b) {
      if ((ok_lo | ok_hi) >> b & 1u) {
        const int sg = kv_segs[row0 + k0 + 8 * (b >> 1) + 2 * tig + (b & 1)];
        if (sg != seg_lo) ok_lo &= ~(1u << b);
        if (sg != seg_hi) ok_hi &= ~(1u << b);
      }
    }
  } else {
    if (seg_lo != kt.mn) ok_lo = 0;
    if (seg_hi != kt.mn) ok_hi = 0;
  }
}

// dS of one key tile for a thread's two rows, packed to bf16 in the A
// layout: P = exp2(S*c - LSE*log2e), 0 where a bit is clear when kTest;
// dS = P*(dP - delta). s and dp are only read.
template <bool kTest, int BN>
__device__ __forceinline__ void form_ds(const float (&s)[BN / 2],
                                        const float (&dp)[BN / 2],
                                        uint32_t (&ds)[BN / 4], float c,
                                        float l_lo, float l_hi, float d_lo,
                                        float d_hi, uint32_t ok_lo,
                                        uint32_t ok_hi) {
#pragma unroll
  for (int j = 0; j < BN / 4; ++j) {
    const bool lo = (j & 1) == 0;  // elements 2j, 2j+1: one row half
    const float l = lo ? l_lo : l_hi, d = lo ? d_lo : d_hi;
    float p0 = ex2(fmaf(s[2 * j], c, -l));
    float p1 = ex2(fmaf(s[2 * j + 1], c, -l));
    if (kTest) {
      p0 = bit_ok(ok_lo, ok_hi, 2 * j) ? p0 : 0.f;
      p1 = bit_ok(ok_lo, ok_hi, 2 * j + 1) ? p1 : 0.f;
    }
    ds[j] = pack_bf16(p0 * (dp[2 * j] - d), p1 * (dp[2 * j + 1] - d));
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_dq,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ kv_mask,
                    const int* __restrict__ q_segs,
                    const int* __restrict__ kv_segs,
                    __nv_bfloat16* __restrict__ dq, int B, int S, int H,
                    int Hkv, float scale, int causal) {
  using C = DqCfg<D>;
  using TQ = typename C::TQ;
  using TK = typename C::TK;
  constexpr int BN = C::kBlockN;
  constexpr int NS = C::kStages;

  // Shared memory (1024-byte aligned, as the 128-byte swizzle wants): two
  // {Q, dO} buffers, the K ring, the V ring, the barriers, the two buffers'
  // LSE*log2e and delta rows, then per list buffer {q seg min, max, tile
  // count, pad} and the two tile lists.
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sK = sQ + 2 * C::kQBytes;
  const uint32_t sV = sK + NS * TK::kBytes;
  const uint32_t bar0 = base + C::kTilesBytes;
  auto barQF = [&](int qb) { return bar0 + 8u * qb; };        // Q, dO, rows in
  auto barQE = [&](int qb) { return bar0 + 8u * (2 + qb); };  // dQ stored
  auto barK = [&](int st) { return bar0 + 8u * (4 + st); };
  auto barV = [&](int st) { return bar0 + 8u * (4 + NS + st); };
  auto barEK = [&](int st) { return bar0 + 8u * (4 + 2 * NS + st); };
  auto barEV = [&](int st) { return bar0 + 8u * (4 + 3 * NS + st); };
  auto barLF = [&](int lb) { return bar0 + 8u * (4 + 4 * NS + lb); };
  auto barLE = [&](int lb) { return bar0 + 8u * (6 + 4 * NS + lb); };
  float* sRows = reinterpret_cast<float*>(smem + C::kTilesBytes + 8 * C::kBars);
  // rows of Q buffer qb: LSE*log2e at sRows + qb*256, delta 128 further
  int* sInfo = reinterpret_cast<int*>(smem + C::kTilesBytes + 8 * C::kBars +
                                      C::kRowsBytes);
  const int n_qt = (S + kItemRows - 1) / kItemRows;
  const int n_kt = (S + BN - 1) / BN;
  int* sList = sInfo + 8;  // [2][n_kt]
  const int n_items = B * H * n_qt;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(barQF(qb), 2);  // the copies' transaction, the rows' warp
      mbar_init(barQE(qb), 2);  // once dQ's store has read it, per warpgroup
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

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8) {
      // ---- loader: Q, dO and their rows per item; K/V tiles into the ring
      int nq = 0, tc = 0;
      for (int n = 0, item = blockIdx.x; item < n_items;
           ++n, item += gridDim.x) {
        const int lb = n & 1;
        mbar_wait(barLF(lb), (n >> 1) & 1);
        const int count = sInfo[4 * lb + 2];
        const int* list = sList + lb * n_kt;
        if (count > 0) {
          const DqItem it = decode_dq<BN>(item, n_qt, S, B, H, Hkv, causal);
          const int qb = nq & 1;
          const long lrow = (static_cast<long>(it.b) * H + it.h) * S;
          float l[kItemRows / 32], d[kItemRows / 32];
#pragma unroll
          for (int i = 0; i < kItemRows / 32; ++i) {
            const int r = it.q0 + 32 * i + lane;
            l[i] = r < S ? lse[lrow + r] * kLog2e : 0.f;
            d[i] = r < S ? delta[lrow + r] : 0.f;
          }
          mbar_wait(barQE(qb), ((nq >> 1) & 1) ^ 1);  // first turn: free
          if (lane == 0) {
            mbar_expect_tx(barQF(qb), 2 * TQ::kBytes);
#pragma unroll
            for (int box = 0; box < TQ::kBoxes; ++box) {
              tma_load(sQ + qb * C::kQBytes + box * TQ::kBoxBytes, &tm_q,
                       barQF(qb), box * kBoxCols, it.h, it.q0, it.b);
              tma_load(sQ + qb * C::kQBytes + TQ::kBytes + box * TQ::kBoxBytes,
                       &tm_do, barQF(qb), box * kBoxCols, it.h, it.q0, it.b);
            }
          }
          float* rows = sRows + qb * 2 * kItemRows;
#pragma unroll
          for (int i = 0; i < kItemRows / 32; ++i) {
            rows[32 * i + lane] = l[i];
            rows[kItemRows + 32 * i + lane] = d[i];
          }
          __syncwarp();
          if (lane == 0) {
            mbar_arrive(barQF(qb));
            for (int i = 0; i < count; ++i) {
              const int k0 = (list[i] & (kNeedMask - 1)) * BN;
              const int st = (tc + i) % NS;
              const uint32_t free_par = (((tc + i) / NS) & 1) ^ 1;
              mbar_wait(barEK(st), free_par);
              mbar_expect_tx(barK(st), TK::kBytes);
#pragma unroll
              for (int box = 0; box < TK::kBoxes; ++box)
                tma_load(sK + st * TK::kBytes + box * TK::kBoxBytes, &tm_k,
                         barK(st), box * kBoxCols, it.hkv, k0, it.b);
              mbar_wait(barEV(st), free_par);
              mbar_expect_tx(barV(st), TK::kBytes);
#pragma unroll
              for (int box = 0; box < TK::kBoxes; ++box)
                tma_load(sV + st * TK::kBytes + box * TK::kBoxBytes, &tm_v,
                         barV(st), box * kBoxCols, it.hkv, k0, it.b);
            }
          }
          __syncwarp();
          ++nq;
          tc += count;
        }
        if (lane == 0) mbar_arrive(barLE(lb));
      }
    } else {
      // ---- walkers: the next items' tile lists, ahead of the consumers ----
      for (int n = 0, item = blockIdx.x; item < n_items;
           ++n, item += gridDim.x) {
        const int lb = n & 1;
        mbar_wait(barLE(lb), ((n >> 1) & 1) ^ 1);  // first turn: free
        walk_dq<BN>(decode_dq<BN>(item, n_qt, S, B, H, Hkv, causal), S,
                    kv_mask, q_segs, kv_segs, sInfo + 4 * lb,
                    sList + lb * n_kt, warp - 9, lane, barLF(lb));
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows [64 wg, 64 wg + 64) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);
    const int g = lane >> 2, tig = lane & 3;
    const int wrow = wg * 64 + (warp % 4) * 16 + g;  // the thread's row in the tile
    const float c = scale * kLog2e;  // exp(scale*s - lse) = exp2(s*c - lse*log2e)
    float acc[D / 2];
    uint32_t zero = 0, one = 1;
    asm volatile("" : "+r"(zero), "+r"(one));
    int nq = 0, tc = 0;
    const bool storer = warp % 4 == 0 && lane == 0;
    int o_buf = -1;  // the Q buffer of the last dQ stored, until it is read
    for (int n = 0, item = blockIdx.x; item < n_items; ++n, item += gridDim.x) {
      const int lb = n & 1;
      mbar_wait(barLF(lb), (n >> 1) & 1);
      const DqItem it = decode_dq<BN>(item, n_qt, S, B, H, Hkv, causal);
      const int wg_q0 = it.q0 + wg * 64;
      const int r_lo = it.q0 + wrow, r_hi = r_lo + 8;
      const int seg_lo = q_segs != nullptr && r_lo < S ? q_segs[it.row0 + r_lo] : 0;
      const int seg_hi = q_segs != nullptr && r_hi < S ? q_segs[it.row0 + r_hi] : 0;
      const int count = sInfo[4 * lb + 2];
      const int* list = sList + lb * n_kt;
      const int qb = nq & 1;
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
      if (count > 0) {
        const uint32_t q_addr = sQ + qb * C::kQBytes + wg * 64 * kRowBytes;
        const uint32_t do_addr = q_addr + TQ::kBytes;
        mbar_wait(barQF(qb), (nq >> 1) & 1);
        const float* rows = sRows + qb * 2 * kItemRows;
        const float l_lo = rows[wrow], l_hi = rows[wrow + 8];
        const float d_lo = rows[kItemRows + wrow], d_hi = rows[kItemRows + wrow + 8];
        for (int i = 0; i < count; ++i) {
          const int e = list[i];
          const int k0 = (e & (kNeedMask - 1)) * BN;
          const int st = (tc + i) % NS;
          const uint32_t par = ((tc + i) / NS) & 1;
          const bool test = (e & kNeedMask) || (causal && k0 + BN - 1 > wg_q0);
          float s[BN / 2], dp[BN / 2];
          uint32_t ds[BN / 4];
          {
            uint64_t dq_[D / 16], dk_[D / 16], ddo[D / 16], dv_[D / 16];
#pragma unroll
            for (int ks = 0; ks < D / 16; ++ks) {
              dq_[ks] = kmajor_desc<TQ::kBoxBytes>(q_addr, ks);
              ddo[ks] = kmajor_desc<TQ::kBoxBytes>(do_addr, ks);
              dk_[ks] = kmajor_desc<TK::kBoxBytes>(sK + st * TK::kBytes, ks);
              dv_[ks] = kmajor_desc<TK::kBoxBytes>(sV + st * TK::kBytes, ks);
            }
            pin(dq_);
            pin(ddo);
            pin(dk_);
            pin(dv_);
            mbar_wait(barK(st), par);
            mbar_wait(barV(st), par);
            wgmma_fence();
            issue_ss<D, BN>(s, dq_, dk_, zero, one);   // S = Q K^T
            issue_ss<D, BN>(dp, ddo, dv_, zero, one);  // dP = dO V^T
            wgmma_commit();
          }
          if (i == 0) {  // the previous dQ's buffer, for a next Q
            if (o_buf >= 0 && storer) {
              bulk_wait_read();
              mbar_arrive(barQE(o_buf));
            }
            o_buf = -1;
          }
          uint32_t ok_lo = ~0u, ok_hi = ~0u;
          KeyTile<BN> kt;
          if (test) kt = key_tile<BN>(k0, S, kv_mask, kv_segs, it.row0, lane);
          wgmma_wait<0>();
          pin(s);
          pin(dp);
          mbar_arrive(barEV(st));  // this stage's V is read
          if (test) {
            dq_tile_bits<BN>(kt, k0, kv_segs, it.row0, causal, tig, r_lo,
                             seg_lo, seg_hi, ok_lo, ok_hi);
            form_ds<true, BN>(s, dp, ds, c, l_lo, l_hi, d_lo, d_hi, ok_lo,
                              ok_hi);
          } else {
            form_ds<false, BN>(s, dp, ds, c, l_lo, l_hi, d_lo, d_hi, ok_lo,
                               ok_hi);
          }
          uint64_t dkt[BN / 16];
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk)
            dkt[kk] = mnmajor_desc<TK::kBoxBytes>(sK + st * TK::kBytes, kk);
          pin(dkt);
          pin(ds);
          pin(acc);
          wgmma_fence();
          issue_rs<BN / 16>(acc, ds, dkt, one);  // dQ += dS K
          wgmma_commit();
          wgmma_wait<0>();
          pin(acc);
          pin(ds);
          mbar_arrive(barEK(st));  // and its K
        }
        tc += count;
      }
      mbar_arrive(barLE(lb));

      if (count > 0) {
        // scale*dQ into this item's Q rows of the warpgroup (read for the last
        // time; 128-byte swizzle, as the map's), then one TMA store of 64 rows
        const uint32_t o_smem = sQ + qb * C::kQBytes + wg * 64 * kRowBytes;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = (warp % 4) * 16 + g + 8 * hf;
            const uint32_t addr = o_smem + (dt / 8) * TQ::kBoxBytes +
                                  row * kRowBytes +
                                  (((dt % 8) ^ (row & 7)) * 16) + tig * 4;
            asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr),
                         "r"(pack_bf16(acc[4 * dt + 2 * hf] * scale,
                                       acc[4 * dt + 2 * hf + 1] * scale))
                         : "memory");
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
        if (storer) {
#pragma unroll
          for (int box = 0; box < TQ::kBoxes; ++box)
            tma_store(&tm_dq, o_smem + box * TQ::kBoxBytes, box * kBoxCols,
                      it.h, wg_q0, it.b);
          bulk_commit();
        }
        o_buf = qb;
        ++nq;
      } else {  // no key to attend: dQ = 0
        const long q_stride = static_cast<long>(H) * D;
        __nv_bfloat16* o_lo =
            dq + (it.row0 + r_lo) * q_stride + static_cast<long>(it.h) * D;
        __nv_bfloat16* o_hi = o_lo + 8 * q_stride;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          const int col = dt * 8 + tig * 2;
          if (r_lo < S) *reinterpret_cast<uint32_t*>(o_lo + col) = 0u;
          if (r_hi < S) *reinterpret_cast<uint32_t*>(o_hi + col) = 0u;
        }
      }
    }
    if (storer) bulk_wait();  // dQ's last stores, before the block ends
  }
}

// -- K3: dK, dV ----------------------------------------------------------------

template <int D>
struct DkvCfg {
  static constexpr int kBlockM = D == 64 ? 128 : 64;  // q rows per stage
  static constexpr int kStages = D == 64 ? 3 : 2;
  using TK = Tile<D, kItemRows>;  // K or V of an item
  using TQ = Tile<D, kBlockM>;    // Q or dO of a stage
  static constexpr int kKVBytes = 2 * TK::kBytes;     // K then V
  static constexpr int kStageBytes = 2 * TQ::kBytes;  // Q then dO
  static constexpr int kTilesBytes = 2 * kKVBytes + kStages * kStageBytes;
  // K/V full and empty x 2; stage full, stage empty x stages; list full and
  // empty x 2
  static constexpr int kBars = 8 + 2 * kStages;
  // per stage: LSE*log2e, delta and q segment id of each row
  static constexpr int kRowsBytes = kStages * 3 * kBlockM * 4;
};

// A K3 item: a (batch*kv head, 128-key tile) pair. Without causal the items
// go head by head; with causal the key tiles go from the first, which the
// most q tiles see, up, all heads at once.
struct DkvItem {
  int b, hkv, k0;
  long row0;  // this batch's row of the [B, S] masks
};

__device__ __forceinline__ DkvItem decode_dkv(int item, int n_kt, int S, int B,
                                              int Hkv, int causal) {
  DkvItem it;
  const int bh = causal ? item % (B * Hkv) : item / n_kt;
  const int kt = causal ? item / (B * Hkv) : item % n_kt;
  it.b = bh / Hkv;
  it.hkv = bh % Hkv;
  it.k0 = kt * kItemRows;
  it.row0 = static_cast<long>(it.b) * S;
  return it;
}

// The q tiles of one K3 item that can see some key of its key tile, in
// order, into `list` (| kNeedMask unless every row of the q tile may attend
// every key of the tile), their count into info[2]; then `bar_full`. No q
// tile when no key of the tile may be attended at all; under causal none
// that ends before the tile's first key; with segments none whose [min,
// max] id range misses the live keys'. The walker warps together.
template <int BM>
__device__ __forceinline__ void walk_dkv(const DkvItem& it, int S,
                                         const int* kv_mask, const int* q_segs,
                                         const int* kv_segs, int causal,
                                         int* info, int* list, int ww,
                                         int lane, uint32_t bar_full) {
  const bool has_segs = q_segs != nullptr;
  if (ww == 0) {
    const KeyTile<kItemRows> kt =
        key_tile<kItemRows>(it.k0, S, kv_mask, kv_segs, it.row0, lane);
    bool any_ok = false, all_ok = true;
#pragma unroll
    for (int i = 0; i < kItemRows / 32; ++i) {
      any_ok = any_ok || kt.w[i] != 0u;
      all_ok = all_ok && kt.w[i] == ~0u;
    }
    if (lane == 0) {
      info[0] = kt.mn;
      info[1] = kt.mx;
      info[3] = (any_ok ? 1 : 0) | (all_ok ? 2 : 0);
    }
  }
  walkers_sync();
  const int kmin = info[0], kmax = info[1], flags = info[3];
  const int n_qt = (S + BM - 1) / BM;
  for (int t = ww; t < n_qt; t += kWalkers) {
    const int q0 = t * BM;
    bool keep = (flags & 1) && (!causal || q0 + BM - 1 >= it.k0);
    bool clean = (flags & 2) && (!causal || q0 >= it.k0 + kItemRows - 1);
    if (has_segs && keep) {
      int mn, mx;
      seg_range(q_segs, it.row0, q0, min(q0 + BM, S), lane, mn, mx);
      keep = mn <= kmax && mx >= kmin;
      clean = clean && mn == mx && kmin == kmax && mn == kmin;
    }
    if (lane == 0) list[t] = keep ? (t | (clean ? 0 : kNeedMask)) : -1;
  }
  walkers_sync();
  if (ww == 0) compact_list(list, n_qt, info + 2, lane, bar_full);
}

// P^T and dS^T of one q stage for a thread's two keys, packed to bf16 in the
// A layout. Column (q row) 8jt + 2tig + x of the stage reads its LSE*log2e
// and delta from shared memory; s and dp are only read.
template <bool kTest, int BM>
__device__ __forceinline__ void form_pds(const float (&s)[BM / 2],
                                         const float (&dp)[BM / 2],
                                         uint32_t (&p)[BM / 4],
                                         uint32_t (&ds)[BM / 4], float c,
                                         const float* lrow, const float* drow,
                                         int tig, uint32_t ok_lo,
                                         uint32_t ok_hi) {
#pragma unroll
  for (int j = 0; j < BM / 4; ++j) {
    const int col = 8 * (j >> 1) + 2 * tig;  // elements 2j, 2j+1
    const float2 l = *reinterpret_cast<const float2*>(lrow + col);
    const float2 d = *reinterpret_cast<const float2*>(drow + col);
    float p0 = ex2(fmaf(s[2 * j], c, -l.x));
    float p1 = ex2(fmaf(s[2 * j + 1], c, -l.y));
    if (kTest) {
      p0 = bit_ok(ok_lo, ok_hi, 2 * j) ? p0 : 0.f;
      p1 = bit_ok(ok_lo, ok_hi, 2 * j + 1) ? p1 : 0.f;
    }
    p[j] = pack_bf16(p0, p1);
    ds[j] = pack_bf16(p0 * (dp[2 * j] - d.x), p1 * (dp[2 * j + 1] - d.y));
  }
}

// The (key, q row) pairs of a q stage that a thread's keys may attend: the
// keys' own mask, causal (row >= key), then segment ids from the stage.
template <int BM>
__device__ __forceinline__ void dkv_stage_bits(bool kok_lo, bool kok_hi,
                                               int key_lo, int q0, int causal,
                                               const int* qseg, int kseg_lo,
                                               int kseg_hi, int tig,
                                               uint32_t& ok_lo,
                                               uint32_t& ok_hi) {
  ok_lo = kok_lo ? ~0u : 0u;
  ok_hi = kok_hi ? ~0u : 0u;
  if (causal) {  // clear the rows before each key
    ok_lo &= ~prefix_bits(key_lo - 1, q0, tig);
    ok_hi &= ~prefix_bits(key_lo + 7, q0, tig);
  }
  if (qseg != nullptr) {
#pragma unroll
    for (int b = 0; b < BM / 4; ++b) {
      const int sg = qseg[8 * (b >> 1) + 2 * tig + (b & 1)];
      if (sg != kseg_lo) ok_lo &= ~(1u << b);
      if (sg != kseg_hi) ok_hi &= ~(1u << b);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_dk,
                     const __grid_constant__ CUtensorMap tm_dv,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ kv_mask,
                     const int* __restrict__ q_segs,
                     const int* __restrict__ kv_segs,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int B, int S, int H,
                     int Hkv, float scale, int causal) {
  using C = DkvCfg<D>;
  using TQ = typename C::TQ;
  using TK = typename C::TK;
  constexpr int BM = C::kBlockM;
  constexpr int NS = C::kStages;

  // Shared memory: two {K, V} buffers, the ring of {Q, dO} stages, the
  // barriers, the stages' rows, then per list buffer {key seg min, max, q
  // tile count, flags} and the two q tile lists.
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sKV = base;
  const uint32_t sStage = sKV + 2 * C::kKVBytes;
  const uint32_t bar0 = base + C::kTilesBytes;
  auto barKF = [&](int kb) { return bar0 + 8u * kb; };        // K, V in
  auto barKE = [&](int kb) { return bar0 + 8u * (2 + kb); };  // dK, dV stored
  auto barSF = [&](int st) { return bar0 + 8u * (4 + st); };
  auto barSE = [&](int st) { return bar0 + 8u * (4 + NS + st); };
  auto barLF = [&](int lb) { return bar0 + 8u * (4 + 2 * NS + lb); };
  auto barLE = [&](int lb) { return bar0 + 8u * (6 + 2 * NS + lb); };
  float* sRows = reinterpret_cast<float*>(smem + C::kTilesBytes + 8 * C::kBars);
  // stage st's rows: LSE*log2e at sRows + 3*BM*st, delta BM further, then
  // the q segment ids
  int* sInfo = reinterpret_cast<int*>(smem + C::kTilesBytes + 8 * C::kBars +
                                      C::kRowsBytes);
  const int n_kt = (S + kItemRows - 1) / kItemRows;
  const int n_qt = (S + BM - 1) / BM;
  int* sList = sInfo + 8;  // [2][n_qt]
  const int n_items = B * Hkv * n_kt;
  const int group = H / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int kb = 0; kb < 2; ++kb) {
      mbar_init(barKF(kb), 1);
      mbar_init(barKE(kb), 2);  // once dK's and dV's stores have read it
    }
    for (int st = 0; st < NS; ++st) {
      mbar_init(barSF(st), 2);  // the copies' transaction, the rows' warp
      mbar_init(barSE(st), 2 * 128);
    }
    for (int lb = 0; lb < 2; ++lb) {
      mbar_init(barLF(lb), 1);
      mbar_init(barLE(lb), 2 * 128 + 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8) {
      // ---- loader: K and V per item; (head, q tile) stages into the ring
      int nkv = 0, sc = 0;
      for (int n = 0, item = blockIdx.x; item < n_items;
           ++n, item += gridDim.x) {
        const int lb = n & 1;
        mbar_wait(barLF(lb), (n >> 1) & 1);
        const int count = sInfo[4 * lb + 2];
        const int* list = sList + lb * n_qt;
        if (count > 0) {
          const DkvItem it = decode_dkv(item, n_kt, S, B, Hkv, causal);
          const int kb = nkv & 1;
          if (lane == 0) {
            mbar_wait(barKE(kb), ((nkv >> 1) & 1) ^ 1);  // first turn: free
            mbar_expect_tx(barKF(kb), C::kKVBytes);
#pragma unroll
            for (int box = 0; box < TK::kBoxes; ++box) {
              tma_load(sKV + kb * C::kKVBytes + box * TK::kBoxBytes, &tm_k,
                       barKF(kb), box * kBoxCols, it.hkv, it.k0, it.b);
              tma_load(sKV + kb * C::kKVBytes + TK::kBytes + box * TK::kBoxBytes,
                       &tm_v, barKF(kb), box * kBoxCols, it.hkv, it.k0, it.b);
            }
          }
          ++nkv;
          for (int gi = 0; gi < group; ++gi) {
            const int h = it.hkv * group + gi;
            const long lrow = (static_cast<long>(it.b) * H + h) * S;
            for (int i = 0; i < count; ++i, ++sc) {
              const int q0 = (list[i] & (kNeedMask - 1)) * BM;
              float l[BM / 32], d[BM / 32];
              int sg[BM / 32];
#pragma unroll
              for (int r = 0; r < BM / 32; ++r) {
                const int row = q0 + 32 * r + lane;
                l[r] = row < S ? lse[lrow + row] * kLog2e : 0.f;
                d[r] = row < S ? delta[lrow + row] : 0.f;
                sg[r] = q_segs != nullptr && row < S ? q_segs[it.row0 + row] : 0;
              }
              const int st = sc % NS;
              mbar_wait(barSE(st), ((sc / NS) & 1) ^ 1);  // first turn: free
              if (lane == 0) {
                mbar_expect_tx(barSF(st), C::kStageBytes);
                const uint32_t dst = sStage + st * C::kStageBytes;
#pragma unroll
                for (int box = 0; box < TQ::kBoxes; ++box) {
                  tma_load(dst + box * TQ::kBoxBytes, &tm_q, barSF(st),
                           box * kBoxCols, h, q0, it.b);
                  tma_load(dst + TQ::kBytes + box * TQ::kBoxBytes, &tm_do,
                           barSF(st), box * kBoxCols, h, q0, it.b);
                }
              }
              float* rows = sRows + 3 * BM * st;
#pragma unroll
              for (int r = 0; r < BM / 32; ++r) {
                rows[32 * r + lane] = l[r];
                rows[BM + 32 * r + lane] = d[r];
                reinterpret_cast<int*>(rows)[2 * BM + 32 * r + lane] = sg[r];
              }
              __syncwarp();
              if (lane == 0) mbar_arrive(barSF(st));
            }
          }
        }
        if (lane == 0) mbar_arrive(barLE(lb));
        __syncwarp();
      }
    } else {
      // ---- walkers: the next items' q tile lists, ahead of the consumers ----
      for (int n = 0, item = blockIdx.x; item < n_items;
           ++n, item += gridDim.x) {
        const int lb = n & 1;
        mbar_wait(barLE(lb), ((n >> 1) & 1) ^ 1);  // first turn: free
        walk_dkv<BM>(decode_dkv(item, n_kt, S, B, Hkv, causal), S, kv_mask,
                     q_segs, kv_segs, causal, sInfo + 4 * lb,
                     sList + lb * n_qt, warp - 9, lane, barLF(lb));
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys [64 wg, 64 wg + 64) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);
    const int g = lane >> 2, tig = lane & 3;
    const int wrow = wg * 64 + (warp % 4) * 16 + g;  // the thread's key in the tile
    const float c = scale * kLog2e;
    float acc_k[D / 2], acc_v[D / 2];
    uint32_t zero = 0, one = 1;
    asm volatile("" : "+r"(zero), "+r"(one));
    int nkv = 0, sc = 0;
    const bool storer = warp % 4 == 0 && lane == 0;
    int o_buf = -1;  // the K/V buffer of the last dK/dV stored, until read
    if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
    for (int n = 0, item = blockIdx.x; item < n_items; ++n, item += gridDim.x) {
      const int lb = n & 1;
      mbar_wait(barLF(lb), (n >> 1) & 1);
      const DkvItem it = decode_dkv(item, n_kt, S, B, Hkv, causal);
      const int key_lo = it.k0 + wrow, key_hi = key_lo + 8;
      const int count = sInfo[4 * lb + 2];
      const int* list = sList + lb * n_qt;
      const int kb = nkv & 1;
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc_k[j] = acc_v[j] = 0.f;
      if (count > 0) {
        const bool kok_lo =
            key_lo < S && (kv_mask == nullptr || kv_mask[it.row0 + key_lo] != 0);
        const bool kok_hi =
            key_hi < S && (kv_mask == nullptr || kv_mask[it.row0 + key_hi] != 0);
        const int kseg_lo =
            kv_segs != nullptr && key_lo < S ? kv_segs[it.row0 + key_lo] : 0;
        const int kseg_hi =
            kv_segs != nullptr && key_hi < S ? kv_segs[it.row0 + key_hi] : 0;
        const uint32_t k_addr = sKV + kb * C::kKVBytes + wg * 64 * kRowBytes;
        const uint32_t v_addr = k_addr + TK::kBytes;
        mbar_wait(barKF(kb), (nkv >> 1) & 1);
        for (int e = 0; e < group * count; ++e, ++sc) {
          const int entry = list[e % count];
          const int q0 = (entry & (kNeedMask - 1)) * BM;
          const bool test = (entry & kNeedMask) != 0;
          const int st = sc % NS;
          const uint32_t q_addr = sStage + st * C::kStageBytes;
          const uint32_t do_addr = q_addr + TQ::kBytes;
          float s[BM / 2], dp[BM / 2];
          uint32_t p[BM / 4], ds[BM / 4];
          {
            uint64_t dk_[D / 16], dv_[D / 16], dq_[D / 16], ddo[D / 16];
#pragma unroll
            for (int ks = 0; ks < D / 16; ++ks) {
              dk_[ks] = kmajor_desc<TK::kBoxBytes>(k_addr, ks);
              dv_[ks] = kmajor_desc<TK::kBoxBytes>(v_addr, ks);
              dq_[ks] = kmajor_desc<TQ::kBoxBytes>(q_addr, ks);
              ddo[ks] = kmajor_desc<TQ::kBoxBytes>(do_addr, ks);
            }
            pin(dk_);
            pin(dv_);
            pin(dq_);
            pin(ddo);
            mbar_wait(barSF(st), (sc / NS) & 1);
            turn_wait(wg);
            wgmma_fence();
            issue_ss<D, BM>(s, dk_, dq_, zero, one);   // S^T = K Q^T
            issue_ss<D, BM>(dp, dv_, ddo, zero, one);  // dP^T = V dO^T
            wgmma_commit();
            turn_pass(wg);
          }
          if (e == 0) {  // the previous dK/dV's buffers, for a next K/V
            if (o_buf >= 0 && storer) {
              bulk_wait_read();
              mbar_arrive(barKE(o_buf));
            }
            o_buf = -1;
          }
          const float* rows = sRows + 3 * BM * st;
          uint32_t ok_lo = ~0u, ok_hi = ~0u;
          if (test)
            dkv_stage_bits<BM>(kok_lo, kok_hi, key_lo, q0, causal,
                               q_segs != nullptr
                                   ? reinterpret_cast<const int*>(rows) + 2 * BM
                                   : nullptr,
                               kseg_lo, kseg_hi, tig, ok_lo, ok_hi);
          wgmma_wait<0>();
          pin(s);
          pin(dp);
          if (test)
            form_pds<true, BM>(s, dp, p, ds, c, rows, rows + BM, tig, ok_lo,
                               ok_hi);
          else
            form_pds<false, BM>(s, dp, p, ds, c, rows, rows + BM, tig, ok_lo,
                                ok_hi);
          uint64_t dot[BM / 16], dqt[BM / 16];
#pragma unroll
          for (int kk = 0; kk < BM / 16; ++kk) {
            dot[kk] = mnmajor_desc<TQ::kBoxBytes>(do_addr, kk);
            dqt[kk] = mnmajor_desc<TQ::kBoxBytes>(q_addr, kk);
          }
          pin(dot);
          pin(dqt);
          pin(p);
          pin(ds);
          pin(acc_v);
          pin(acc_k);
          turn_wait(wg);
          wgmma_fence();
          issue_rs<BM / 16>(acc_v, p, dot, one);   // dV += P^T dO
          issue_rs<BM / 16>(acc_k, ds, dqt, one);  // dK += dS^T Q
          wgmma_commit();
          turn_pass(wg);
          wgmma_wait<0>();
          pin(acc_v);
          pin(acc_k);
          pin(p);
          pin(ds);
          mbar_arrive(barSE(st));  // this stage's Q and dO are read
        }
      }
      mbar_arrive(barLE(lb));

      if (count > 0) {
        // scale*dK and dV into this item's K and V rows of the warpgroup (read
        // for the last time), then a TMA store of 64 rows each
        const uint32_t k_smem = sKV + kb * C::kKVBytes + wg * 64 * kRowBytes;
        const uint32_t v_smem = k_smem + TK::kBytes;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = (warp % 4) * 16 + g + 8 * hf;
            const uint32_t off = (dt / 8) * TK::kBoxBytes + row * kRowBytes +
                                 (((dt % 8) ^ (row & 7)) * 16) + tig * 4;
            asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(k_smem + off),
                         "r"(pack_bf16(acc_k[4 * dt + 2 * hf] * scale,
                                       acc_k[4 * dt + 2 * hf + 1] * scale))
                         : "memory");
            asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(v_smem + off),
                         "r"(pack_bf16(acc_v[4 * dt + 2 * hf],
                                       acc_v[4 * dt + 2 * hf + 1]))
                         : "memory");
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
        if (storer) {
#pragma unroll
          for (int box = 0; box < TK::kBoxes; ++box) {
            tma_store(&tm_dk, k_smem + box * TK::kBoxBytes, box * kBoxCols,
                      it.hkv, it.k0 + wg * 64, it.b);
            tma_store(&tm_dv, v_smem + box * TK::kBoxBytes, box * kBoxCols,
                      it.hkv, it.k0 + wg * 64, it.b);
          }
          bulk_commit();
        }
        o_buf = kb;
        ++nkv;
      } else {  // no key of the tile may be attended: dK = dV = 0
        const long kv_stride = static_cast<long>(Hkv) * D;
        const long off_lo = (it.row0 + key_lo) * kv_stride +
                            static_cast<long>(it.hkv) * D;
        const long off_hi = off_lo + 8 * kv_stride;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          const int col = dt * 8 + tig * 2;
          if (key_lo < S) {
            *reinterpret_cast<uint32_t*>(dk + off_lo + col) = 0u;
            *reinterpret_cast<uint32_t*>(dv + off_lo + col) = 0u;
          }
          if (key_hi < S) {
            *reinterpret_cast<uint32_t*>(dk + off_hi + col) = 0u;
            *reinterpret_cast<uint32_t*>(dv + off_hi + col) = 0u;
          }
        }
      }
    }
    if (wg == 0) turn_wait(wg);  // the last pass, none left pending
    if (storer) bulk_wait();  // the last stores, before the block ends
  }
}

// -- host side -----------------------------------------------------------------

// Once per device and kernel: the shared-memory attribute and the SM count.
template <typename Kernel>
cudaError_t configure(Kernel kernel, bool (&configured)[kMaxDevices],
                      int (&sm_count)[kMaxDevices], int& dev) {
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  return cudaSuccess;
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* kv_mask,
              const void* q_segs, const void* kv_segs, void* dq, int B, int S,
              int H, int Hkv, float scale, int causal, cudaStream_t stream) {
  using C = DqCfg<D>;
  static bool configured[kMaxDevices] = {};
  static int sm_count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = configure(flash_bwd_dq_kernel<D>, configured, sm_count, dev);
  if (err != cudaSuccess) return (int)err;
  const int n_kt = (S + C::kBlockN - 1) / C::kBlockN;
  // alignment slack, tiles, barriers, rows, two {info} and two tile lists
  const size_t smem = 1024 + C::kTilesBytes + 8 * C::kBars + C::kRowsBytes +
                      32 + 8 * (size_t)n_kt;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dq;
  if (!make_map(&tm_q, q, B, S, H, D, kItemRows) ||
      !make_map(&tm_do, dout, B, S, H, D, kItemRows) ||
      !make_map(&tm_k, k, B, S, Hkv, D, C::kBlockN) ||
      !make_map(&tm_v, v, B, S, Hkv, D, C::kBlockN) ||
      !make_map(&tm_dq, dq, B, S, H, D, kItemRows / 2))
    return (int)cudaErrorNotSupported;
  const long items = (long)B * H * ((S + kItemRows - 1) / kItemRows);
  const int blocks = (int)(items < sm_count[dev] ? items : sm_count[dev]);
  flash_bwd_dq_kernel<D><<<blocks, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dq, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(kv_mask),
      static_cast<const int*>(q_segs), static_cast<const int*>(kv_segs),
      static_cast<__nv_bfloat16*>(dq), B, S, H, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* kv_mask,
               const void* q_segs, const void* kv_segs, void* dk, void* dv,
               int B, int S, int H, int Hkv, float scale, int causal,
               cudaStream_t stream) {
  using C = DkvCfg<D>;
  static bool configured[kMaxDevices] = {};
  static int sm_count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = configure(flash_bwd_dkv_kernel<D>, configured, sm_count, dev);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (S + C::kBlockM - 1) / C::kBlockM;
  const size_t smem = 1024 + C::kTilesBytes + 8 * C::kBars + C::kRowsBytes +
                      32 + 8 * (size_t)n_qt;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv;
  if (!make_map(&tm_q, q, B, S, H, D, C::kBlockM) ||
      !make_map(&tm_do, dout, B, S, H, D, C::kBlockM) ||
      !make_map(&tm_k, k, B, S, Hkv, D, kItemRows) ||
      !make_map(&tm_v, v, B, S, Hkv, D, kItemRows) ||
      !make_map(&tm_dk, dk, B, S, Hkv, D, kItemRows / 2) ||
      !make_map(&tm_dv, dv, B, S, Hkv, D, kItemRows / 2))
    return (int)cudaErrorNotSupported;
  const long items = (long)B * Hkv * ((S + kItemRows - 1) / kItemRows);
  const int blocks = (int)(items < sm_count[dev] ? items : sm_count[dev]);
  flash_bwd_dkv_kernel<D><<<blocks, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(kv_mask),
      static_cast<const int*>(q_segs), static_cast<const int*>(kv_segs),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B, S,
      H, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). q, dout, dq: [B, S, H, D] bf16; k, v, dk,
// dv: [B, S, Hkv, D] bf16; lse, delta: [B*H, S] f32; kv_mask, q_segs,
// kv_segs: [B, S] int32 or null (segs both or neither). All contiguous,
// 16-byte aligned. Each returns the CUDA error code of its launch
// (0 = launched).
extern "C" int dls_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse,
                                     const void* delta, const void* kv_mask,
                                     const void* q_segs, const void* kv_segs,
                                     void* dq, int B, int S, int H, int Hkv,
                                     int D, float scale, int causal,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, kv_mask, q_segs, kv_segs,
                         dq, B, S, H, Hkv, scale, causal, st);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, kv_mask, q_segs, kv_segs,
                          dq, B, S, H, Hkv, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int dls_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse,
                                      const void* delta, const void* kv_mask,
                                      const void* q_segs, const void* kv_segs,
                                      void* dk, void* dv, int B, int S, int H,
                                      int Hkv, int D, float scale, int causal,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, kv_mask, q_segs, kv_segs,
                          dk, dv, B, S, H, Hkv, scale, causal, st);
  if (D == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, kv_mask, q_segs, kv_segs,
                           dk, dv, B, S, H, Hkv, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
