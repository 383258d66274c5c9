// table[idx[i]] += updates[i] over the rows of an f32 table, in place, for
// Hopper (sm_90a). Ids outside [0, V) are dropped.
//
// Replaces the Pallas kernel `_scatter_add_kernel` driven by
// `scatter_add_rows` and `scatter_add_rows_dropping` in
// distributeddeeplearningspark_tpu/ops/scatter_rows.py: the in-place row
// scatter-add that applies the row-wise AdaGrad update of a DLRM embedding
// table (train/embed.py). It computes what that kernel computes, not its
// block structure:
//
//   - the TPU grid walks the K update rows one grid step at a time, with the
//     ids prefetched as scalars into the index maps. Here a group of G lanes
//     (G a power of two, D/4 rounded up and at most 32: 16 at D = 64) owns an
//     update row; a block holds 256 / G groups, and a grid-stride loop walks
//     the rows, so any K runs on a grid sized to the card.
//   - each lane loads the row's id once. An id >= V, or negative, returns
//     before any load of the update: that is the drop. The JAX package's
//     `scatter_add_rows_dropping` copies the whole table into [V + 1, D] to
//     give the sentinels a scratch row (a Mosaic DMA workaround, 665.6 MB a
//     step at the DLRM shape); here the table is never copied.
//   - a read-modify-write of the row: float4 when D % 4 == 0 and the table
//     and updates are 16-byte aligned, one float at a time otherwise
//     (D = 1, 13). The row offset is 64-bit: 2.6M rows x 64 floats overflow
//     a 32-bit element index.
//   - no atomics: the caller's ids are unique among the in-range rows (the
//     contract of the Pallas kernel and of XLA's unique_indices=True), so no
//     two groups touch one row. One f32 add per element makes the result
//     bitwise equal to the plain version.
//   - ids are int32 or int64 (a template parameter); K = 0 launches nothing.
//
// Bound on the card: the kernel does D adds per kept row, nothing against
// 67 TFLOP/s of f32; it must read the K ids, read each kept update row and
// read and write each kept table row. At the DLRM shape (K = 212,992 lookups
// of which about 204,500 are distinct rows, D = 64) that is about 158 MB, so
// about 0.047 ms at 3.35 TB/s: the bytes bound it. The rows lie scattered
// over a 665.6 MB table, so every row is a separate 256-byte segment; a
// group of 16 lanes moves one such segment with one float4 access a lane.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// One group of `group` lanes per update row; `group` divides 32.
template <typename IdxT, bool kVec>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(float* __restrict__ table, const IdxT* __restrict__ idx,
                        const float* __restrict__ upd, long long V, long long K,
                        int D, int group) {
  const int lane = threadIdx.x % group;
  const long long rows_per_block = kThreads / group;
  const long long stride = (long long)gridDim.x * rows_per_block;
  for (long long r = (long long)blockIdx.x * rows_per_block + threadIdx.x / group;
       r < K; r += stride) {
    const long long id = (long long)idx[r];
    if (id < 0 || id >= V) continue;  // dropped before the update is read
    float* __restrict__ dst = table + id * D;
    const float* __restrict__ src = upd + r * D;
    if (kVec) {
      float4* d4 = reinterpret_cast<float4*>(dst);
      const float4* s4 = reinterpret_cast<const float4*>(src);
      for (int c = lane; c < D / 4; c += group) {
        float4 t = d4[c];
        const float4 u = s4[c];
        t.x += u.x;
        t.y += u.y;
        t.z += u.z;
        t.w += u.w;
        d4[c] = t;
      }
    } else {
      for (int c = lane; c < D; c += group) dst[c] += src[c];
    }
  }
}

template <typename IdxT>
cudaError_t launch(float* table, const void* idx, const float* upd, long long V,
                   long long K, int D, cudaStream_t stream) {
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(upd) % 16 == 0;
  const int chunks = vec ? D / 4 : D;
  int group = 1;
  while (group < chunks && group < 32) group <<= 1;
  const long long rows_per_block = kThreads / group;
  long long blocks = (K + rows_per_block - 1) / rows_per_block;
  // enough blocks to fill the card several times over; the loop does the rest
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  const IdxT* ip = static_cast<const IdxT*>(idx);
  if (vec)
    scatter_add_rows_kernel<IdxT, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        table, ip, upd, V, K, D, group);
  else
    scatter_add_rows_kernel<IdxT, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        table, ip, upd, V, K, D, group);
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). table: [V, D] f32, updated in place;
// idx: [K] int32 (idx_is_64 = 0) or int64 (idx_is_64 = 1); updates: [K, D]
// f32. All contiguous, on one device. Ids outside [0, V) are dropped; the
// in-range ids must be unique. Returns the CUDA error code of the launch
// (0 = launched, or nothing to launch when K = 0).
extern "C" int dls_scatter_add_rows_f32(void* table, const void* idx, int idx_is_64,
                                        const void* updates, long long V, long long K,
                                        int D, void* stream) {
  if (V < 0 || K < 0 || D <= 0) return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  float* tp = static_cast<float*>(table);
  const float* up = static_cast<const float*>(updates);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = idx_is_64 ? launch<int64_t>(tp, idx, up, V, K, D, st)
                                    : launch<int32_t>(tp, idx, up, V, K, D, st);
  return (int)err;
}
