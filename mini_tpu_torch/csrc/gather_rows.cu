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
// What bounds it on an H100: bytes, and the latency of scattered reads.
// Each output row is read once from wherever its index points and written
// once, contiguously; there is no arithmetic.  The design follows the
// probes' "idxdma" shape: a block owns a tile of kTileRows output rows,
// first stages the tile's indices in shared memory with one coalesced
// load, then its threads walk the tile's (row, 16-byte vector) pairs in
// order, so neighbouring threads read neighbouring bytes of one source row
// and write neighbouring bytes of one output row.  An F=128 float32 row
// (512 B) is one warp of 16-byte loads; a bf16 row is half a warp, and the
// other half already serves the next row.  Rows whose size or address is
// not a multiple of 16 bytes fall back to 4-, 2- or 1-byte moves.  Each
// thread has several independent loads in flight (the loop is unrolled),
// which hides the scattered reads' latency.  An index outside [0, W)
// writes a zero row instead of reading out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 128;  // output rows per block

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const int* __restrict__ idx, const V* __restrict__ table,
                   V* __restrict__ out, long long M, int W, int row_vecs) {
  __shared__ int s_idx[kTileRows];
  const long long row0 = static_cast<long long>(blockIdx.x) * kTileRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kTileRows),
                                        M - row0));
  for (int r = threadIdx.x; r < rows; r += kThreads) s_idx[r] = idx[row0 + r];
  __syncthreads();
  const int items = rows * row_vecs;
#pragma unroll 4
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int r = it / row_vecs;
    const int v = it - r * row_vecs;
    const int src = s_idx[r];
    V val{};
    if (src >= 0 && src < W)
      val = table[static_cast<size_t>(src) * row_vecs + v];
    out[static_cast<size_t>(row0 + r) * row_vecs + v] = val;
  }
}

template <typename V>
int launch(const int* idx, const void* table, void* out, long long M, int W,
           long long row_bytes, cudaStream_t s) {
  const long long row_vecs = row_bytes / static_cast<long long>(sizeof(V));
  if (row_vecs * kTileRows > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (M + kTileRows - 1) / kTileRows;
  gather_rows_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      idx, static_cast<const V*>(table), static_cast<V*>(out), M, W,
      static_cast<int>(row_vecs));
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
    return launch<uint4>(ix, table, out, M, W, row_bytes, s);
  if (align % 4 == 0)
    return launch<uint32_t>(ix, table, out, M, W, row_bytes, s);
  if (align % 2 == 0)
    return launch<uint16_t>(ix, table, out, M, W, row_bytes, s);
  return launch<uint8_t>(ix, table, out, M, W, row_bytes, s);
}
