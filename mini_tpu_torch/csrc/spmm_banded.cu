// Banded segment sum, the core of every sum-SpMM:
//   out[v, :] = sum_k sum_{j in [offs2d[t,k,r], next)} msgs[k][j, :]
// for v = 128 t + r, where next = offs2d[t,k,r+1], or bounds[k,t+1] for
// r = 127.  K segment-sorted message streams msgs[k] ([mk_pad, F], float32
// or bfloat16) fold into one float32 output [n_tiles * 128, F].  Pad slots
// past a band's last segment end are never read.
//
// Replaces the TPU kernel mini_tpu/ops/pallas/spmm_banded.py,
// banded_segment_sum.  The TPU version builds a one-hot "staircase" per
// 512-edge chunk and multiplies it on the matrix unit, with a bf16 hi/lo
// split for float32 and double-buffered DMA; none of that carries over.
//
// What bounds it on an H100: bytes.  Every message element is read once
// and added once: 0.25 operations per byte for float32 (0.5 for bf16),
// far below the ~295 operations per byte at which the card stops being
// memory-bound.  So the design reads each message row exactly once,
// coalesced, and accumulates in registers: a block owns one 128-row tile
// and a 32-column slice of F; its threadIdx.x is the column (one warp
// reads 128 contiguous bytes of a float32 row) and its 8 warps split the
// tile's rows.  Each thread walks its row's segment in every band in
// order, adding in float32, and writes its output element once.  No
// atomics, so the result is deterministic run to run.
//
// Known limits, for later PRs: the gather x[band][ids] * w that makes the
// messages runs outside the kernel (so messages make a round trip through
// device memory), a hub row serializes onto one warp, and loads are 4 B
// (2 B for bf16) per thread rather than 16 B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowTile = 128;
constexpr int kCols = 32;      // columns per block (threadIdx.x)
constexpr int kRowGroups = 8;  // warps per block (threadIdx.y)
constexpr int kMaxBands = 128;

enum { DT_FLOAT32 = 0, DT_BFLOAT16 = 1 };

// The K stream pointers travel by value in the kernel's parameters.
struct StreamPtrs {
  const void* p[kMaxBands];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kCols * kRowGroups)
banded_segment_sum_kernel(StreamPtrs msgs, const int* __restrict__ bounds,
                          const int* __restrict__ offs2d,
                          float* __restrict__ out, int K, int n_tiles, int F) {
  const int t = blockIdx.x;
  const int c = blockIdx.y * kCols + threadIdx.x;
  if (c >= F) return;
  for (int r = threadIdx.y; r < kRowTile; r += kRowGroups) {
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) {
      const int* off = offs2d + (static_cast<size_t>(t) * K + k) * kRowTile;
      const int s = off[r];
      const int e = (r + 1 < kRowTile)
                        ? off[r + 1]
                        : bounds[static_cast<size_t>(k) * (n_tiles + 1) + t + 1];
      const T* m = static_cast<const T*>(msgs.p[k]) + c;
#pragma unroll 4
      for (int j = s; j < e; ++j) acc += to_f32(m[static_cast<size_t>(j) * F]);
    }
    out[(static_cast<size_t>(t) * kRowTile + r) * F + c] = acc;
  }
}

}  // namespace

extern "C" int banded_max_bands() { return kMaxBands; }

// msg_ptrs: host array of K device pointers.  Returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for bad
// arguments.
extern "C" int banded_segment_sum_launch(const void* const* msg_ptrs, int K,
                                         const void* bounds,
                                         const void* offs2d, void* out,
                                         int n_tiles, int F, int dtype,
                                         void* stream) {
  if (K < 1 || K > kMaxBands || n_tiles < 0 || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  StreamPtrs ptrs = {};
  for (int k = 0; k < K; ++k) ptrs.p[k] = msg_ptrs[k];
  const dim3 grid(n_tiles, (F + kCols - 1) / kCols);
  const dim3 block(kCols, kRowGroups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* b = static_cast<const int*>(bounds);
  const int* o = static_cast<const int*>(offs2d);
  float* y = static_cast<float*>(out);
  if (dtype == DT_FLOAT32) {
    banded_segment_sum_kernel<float><<<grid, block, 0, s>>>(ptrs, b, o, y, K,
                                                            n_tiles, F);
  } else if (dtype == DT_BFLOAT16) {
    banded_segment_sum_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        ptrs, b, o, y, K, n_tiles, F);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
