// Row gather: out[j, :] = table[idx[j], :] for j < M, table [W, row_bytes]
// of any element type (the kernel moves bytes), idx int32 [M].
//
// Replaces the TPU row gathers of the scratch probes:
// scratch/probe_dma_gather.py dma_gather and dma_gather_idxdma (one DMA
// descriptor per row from an HBM table, indices in SMEM),
// scratch/probe_dma_bisect.py (the same gather in four DMA variants) and
// scratch/probe_hbm_and_gather.py dyn_gather (take_along_axis on a
// VMEM-resident table).  All three compute this one function; they differ
// only in how the TPU issues its copies.  Here it carries every band
// gather x[band k][ids[k]] of the banded SpMM and SDDMM, and GAT's.
//
// What bounds it on an H100: bytes.  Each output row is read once from
// wherever its index points and written once, contiguously; there is no
// arithmetic.  A band's table (<= 16 MB) stays in L2, so on the SpMM path
// (2.1M rows of 512 B at rmat16) the write of the gathered rows is the
// floor.  A block owns a tile of output rows, about kTileBytes of them
// (halved down to kMinTileRows until a gather fills kWaveBlocks blocks an
// SM, so a small gather still spreads over the card), stages their indices
// in shared memory with one coalesced load, then its threads walk the
// tile's (row, vector) pairs in order, kBatch loads in flight a thread
// before their stores; the stores stream (__stcs, evict-first), so the
// gathered rows do not push the band table out of L2.  Vectors of 16
// bytes, or 4, 2, 1 where the row size or an address is not a multiple of
// 16.  An index outside [0, W) writes a zero row.
//
// The probes' "one DMA per row", as one cp.async.bulk copy per row through
// shared-memory stages, was measured against this form on an H100 and lost
// at every row size from 160 B to 16 KB (PERF.md): one copy per row of
// 256-512 B leaves the copy engine, not the bytes, as the limit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A block writes about kTileBytes of output: 128 rows of 512 B (F=128
// float32) or 256 of 256 B (bf16).  A sweep on an H100 at the rmat16 band
// gathers (256 or 512 threads, 32-128 KB tiles, 8 or 16 loads in flight,
// streaming or plain stores) put these within 1% of the best for both
// types; the streaming stores were the largest single gain.
constexpr int kThreads = 512;
constexpr int kTileBytes = 65536;
constexpr int kMaxTileRows = 256;  // the staged indices of a tile
constexpr int kMinTileRows = 8;    // fewest: a small gather gets more blocks
constexpr int kWaveBlocks = 2;     // blocks per SM a gather fills before its
                                   // tiles stop shrinking
constexpr int kBatch = 8;          // loads in flight per thread before stores

// the card's SM count, read once
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const int* __restrict__ idx, const V* __restrict__ table,
                   V* __restrict__ out, long long M, int W, int row_vecs,
                   int tile_rows) {
  __shared__ int s_idx[kMaxTileRows];
  const long long row0 = static_cast<long long>(blockIdx.x) * tile_rows;
  const int rows = static_cast<int>(min(static_cast<long long>(tile_rows),
                                        M - row0));
  for (int r = threadIdx.x; r < rows; r += kThreads) s_idx[r] = idx[row0 + r];
  __syncthreads();
  const int items = rows * row_vecs;
  V* dst = out + static_cast<size_t>(row0) * row_vecs;
  for (int base = threadIdx.x; base < items; base += kThreads * kBatch) {
    V val[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int it = base + b * kThreads;
      val[b] = V{};
      if (it < items) {
        const int r = it / row_vecs;
        const int src = s_idx[r];
        if (src >= 0 && src < W)
          val[b] = table[static_cast<size_t>(src) * row_vecs +
                         (it - r * row_vecs)];
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int it = base + b * kThreads;
      if (it < items) __stcs(dst + it, val[b]);
    }
  }
}

template <typename V>
int launch_thread(const int* idx, const void* table, void* out, long long M,
                  int W, long long row_bytes, cudaStream_t s) {
  const long long row_vecs = row_bytes / static_cast<long long>(sizeof(V));
  if (row_vecs * kMaxTileRows > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // the fewest rows (a power of two) that make kTileBytes, then halved
  // until the gather fills kWaveBlocks blocks an SM
  int tile = kMinTileRows;
  while (tile < kMaxTileRows && tile * row_bytes < kTileBytes) tile *= 2;
  const long long wave = static_cast<long long>(sm_count()) * kWaveBlocks;
  while (tile > kMinTileRows && (M + tile - 1) / tile < wave) tile /= 2;
  const long long blocks = (M + tile - 1) / tile;
  gather_rows_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      idx, static_cast<const V*>(table), static_cast<V*>(out), M, W,
      static_cast<int>(row_vecs), tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// idx: int32 [M]; table: [W, row_bytes] bytes; out: [M, row_bytes] bytes.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for bad arguments.
extern "C" int gather_rows_launch(const void* idx, const void* table,
                                  void* out, long long M, int W,
                                  long long row_bytes, void* stream) {
  if (M < 0 || W < 0 || row_bytes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0)
    return launch_thread<uint4>(ix, table, out, M, W, row_bytes, s);
  if (align % 4 == 0)
    return launch_thread<uint32_t>(ix, table, out, M, W, row_bytes, s);
  if (align % 2 == 0)
    return launch_thread<uint16_t>(ix, table, out, M, W, row_bytes, s);
  return launch_thread<uint8_t>(ix, table, out, M, W, row_bytes, s);
}
