// Fixed permutation of up to kMaxPayloads payloads in one launch:
//   forward:  out_p[rank[i]] = in_p[i]   (a scatter by rank)
//   inverse:  out_p[i] = in_p[rank[i]]   (a gather by rank)
// for i < m, rank int32 [m] a permutation of [0, m).  Each payload has its
// own element size (1, 2, 4 or 8 bytes: bool, bf16/f16, f32/i32, f64/i64);
// the kernel moves elements, not values.  The inverse is the transpose of
// the forward, so one kernel serves apply_fixed_perm and its gradient.
//
// Replaces the TPU kernel scratch/probe_butterfly.py (run, kernel): Benes
// butterfly stages over a VMEM-resident array, each stage an exchange of
// element i with i ^ s under a mask bit, 2 log2(m) - 1 stages for any
// permutation.  That network, and the lax.sort that mini_tpu/ops/permute.py
// apply_fixed_perm uses in production, exist because the TPU has no fast
// gather or scatter.  Hopper has both, so the permutation itself is what is
// ported, not the stage schedule.
//
// What bounds it on an H100: bytes.  Each element reads its rank and its
// payloads once (coalesced) and writes each payload once to the rank's
// position (scattered stores, which L2 merges into sectors).  The forward
// is a scatter, not a gather by the inverse rank, so no inverse has to be
// built or stored; the scattered side is the store, whose latency the card
// does not wait for.  The rank is read once for all payloads; the switch on
// a payload's element size is uniform across the block.  A rank outside
// [0, m) is skipped (forward) or reads as 0 (inverse), so a bad rank cannot
// write out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPayloads = 16;

// The payload pointers and element sizes travel by value in the kernel's
// parameters.
struct Payloads {
  const void* in[kMaxPayloads];
  void* out[kMaxPayloads];
  int size[kMaxPayloads];  // bytes per element: 1, 2, 4 or 8
};

template <bool kInverse, typename T>
__device__ __forceinline__ void move_one(const void* in, void* out,
                                         long long i, int r, bool ok) {
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  if (kInverse) {
    dst[i] = ok ? src[r] : T(0);
  } else if (ok) {
    dst[r] = src[i];
  }
}

template <bool kInverse>
__global__ void __launch_bounds__(kThreads)
permute_kernel(const int* __restrict__ rank, Payloads p, int P, long long m) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < m; i += stride) {
    const int r = rank[i];
    const bool ok = r >= 0 && r < m;
    for (int q = 0; q < P; ++q) {
      const void* src = p.in[q];
      void* dst = p.out[q];
      switch (p.size[q]) {
        case 1: move_one<kInverse, uint8_t>(src, dst, i, r, ok); break;
        case 2: move_one<kInverse, uint16_t>(src, dst, i, r, ok); break;
        case 4: move_one<kInverse, uint32_t>(src, dst, i, r, ok); break;
        default: move_one<kInverse, uint64_t>(src, dst, i, r, ok);
      }
    }
  }
}

}  // namespace

extern "C" int permute_max_payloads() { return kMaxPayloads; }

// rank: int32 [m] on the device; in_ptrs, out_ptrs: host arrays of P
// device pointers to [m] arrays (out never aliases in); sizes: host array
// of the P element sizes in bytes.  Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for bad arguments.
extern "C" int permute_launch(const void* rank, const void* const* in_ptrs,
                              void* const* out_ptrs, const int* sizes, int P,
                              long long m, int inverse, void* stream) {
  if (P < 1 || P > kMaxPayloads || m < 0 || m > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Payloads p = {};
  for (int q = 0; q < P; ++q) {
    const int b = sizes[q];
    if (b != 1 && b != 2 && b != 4 && b != 8)
      return static_cast<int>(cudaErrorInvalidValue);
    p.in[q] = in_ptrs[q];
    p.out[q] = out_ptrs[q];
    p.size[q] = b;
  }
  if (m == 0) return 0;
  // enough blocks to fill the card several times over; the grid-stride
  // loop takes the rest
  const long long want = (m + kThreads - 1) / kThreads;
  const unsigned blocks =
      static_cast<unsigned>(want < 132 * 64 ? want : 132 * 64);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rank);
  if (inverse)
    permute_kernel<true><<<blocks, kThreads, 0, s>>>(r, p, P, m);
  else
    permute_kernel<false><<<blocks, kThreads, 0, s>>>(r, p, P, m);
  return static_cast<int>(cudaGetLastError());
}
