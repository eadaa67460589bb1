// Contiguous-segment reduce: out[v] = op(vals[offsets[v] : offsets[v+1]]),
// op in {min, max, sum, bor}, on int32 and float32 (bor on int32 only).
// Empty segments get the identity the caller passes.
//
// Replaces the TPU kernel mini_tpu/ops/pallas/segreduce_kernel.py,
// segment_reduce_pallas (kernel body _segreduce_kernel).  In the port it is
// the engine's per-vertex reduce (ops/engine.reduce_csc_by_dst and
// reduce_csr_by_src): the or-reduce of every BFS advance and the min of
// the BFS predecessor pass.
//
// What bounds it on an H100: bytes.  Each edge value is read once (4 B)
// and combined once, about 0.25 operations per byte, far below the ~295
// operations per byte at which the card stops being memory-bound.  So the
// design reads every value exactly once, coalesced, and keeps the partial
// reductions in registers: one warp per segment (grid-strided over
// segments), its 32 lanes stride over the segment's values, then a
// shuffle fold.  Only offsets and vals are read; the twin's per-edge
// segment ids are not needed.  min, max, bor and the int32 sum (taken in
// unsigned arithmetic, so it wraps like the reference) are bitwise equal
// to any other order; the float32 sum is summed in another order than a
// sequential reference.
//
// Known limit: one warp owns one whole segment, so an RMAT hub and the
// ghost segment (up to m_pad - m pad edges on vertex n_pad - 1) serialize
// onto one warp.  gunrock's load-balanced search (a merge-path split of
// the edge range across warps) is the later fix.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum { OP_MIN = 0, OP_MAX = 1, OP_SUM = 2, OP_BOR = 3 };
enum { DT_INT32 = 0, DT_FLOAT32 = 1 };

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxBlocks = 8192;

template <typename T, int OP>
__device__ __forceinline__ T combine(T a, T b) {
  if constexpr (OP == OP_MIN) {
    return b < a ? b : a;
  } else if constexpr (OP == OP_MAX) {
    return b > a ? b : a;
  } else if constexpr (OP == OP_SUM) {
    if constexpr (std::is_integral_v<T>) {
      // int32: wrapping sum without signed-overflow UB
      return static_cast<T>(static_cast<uint32_t>(a) +
                            static_cast<uint32_t>(b));
    } else {
      return a + b;
    }
  } else {
    return a | b;
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
segreduce_kernel(const int* __restrict__ offsets, const T* __restrict__ vals,
                 T* __restrict__ out, int n, T ident) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarpsPerBlock;
  // v is warp-uniform, so every lane runs the same trip counts and the
  // full-mask shuffles below are safe
  for (int v = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); v < n;
       v += stride) {
    const int s = offsets[v];
    const int e = offsets[v + 1];
    T acc = ident;
    for (int j = s + lane; j < e; j += 32) acc = combine<T, OP>(acc, vals[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc = combine<T, OP>(acc, __shfl_xor_sync(0xffffffffu, acc, o));
    if (lane == 0) out[v] = acc;
  }
}

template <typename T, int OP>
void launch(const void* offsets, const void* vals, void* out, int n, T ident,
            cudaStream_t stream) {
  int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  segreduce_kernel<T, OP><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(offsets), static_cast<const T*>(vals),
      static_cast<T*>(out), n, ident);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unknown dtype/op pair.
extern "C" int segreduce_launch(const void* offsets, const void* vals,
                                void* out, int n, int dtype, int op,
                                double ident_f, long long ident_i,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (dtype == DT_INT32) {
    const int id = static_cast<int>(ident_i);
    switch (op) {
      case OP_MIN: launch<int, OP_MIN>(offsets, vals, out, n, id, s); break;
      case OP_MAX: launch<int, OP_MAX>(offsets, vals, out, n, id, s); break;
      case OP_SUM: launch<int, OP_SUM>(offsets, vals, out, n, id, s); break;
      case OP_BOR: launch<int, OP_BOR>(offsets, vals, out, n, id, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (dtype == DT_FLOAT32) {
    const float id = static_cast<float>(ident_f);
    switch (op) {
      case OP_MIN: launch<float, OP_MIN>(offsets, vals, out, n, id, s); break;
      case OP_MAX: launch<float, OP_MAX>(offsets, vals, out, n, id, s); break;
      case OP_SUM: launch<float, OP_SUM>(offsets, vals, out, n, id, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
