// Fixed permutation of the rows of one table:
//   forward:  out[rank[i]] = in[i]   (a scatter by rank)
//   inverse:  out[i] = in[rank[i]]   (a gather by rank)
// for i < m, rank int32 [m] a permutation of [0, m), in and out contiguous
// [m, row] tables of any element type.  The kernel moves bits, not
// values.  The inverse is the transpose of the forward, so one kernel
// serves apply_fixed_perm, permute_rows and their gradients.
//
// Replaces the TPU kernel scratch/probe_butterfly.py (run, kernel): Benes
// butterfly stages over a VMEM-resident array, each stage an exchange of
// element i with i ^ s under a mask bit, 2 log2(m) - 1 stages for any
// permutation.  That network, and the lax.sort that mini_tpu/ops/permute.py
// apply_fixed_perm uses in production, exist because the TPU has no fast
// gather or scatter.  Hopper has both, so the permutation itself is what is
// ported, not the stage schedule.
//
// What bounds it on an H100: bytes, and the scattered side's transactions.
// Each index reads its rank once and its row once, and writes the row
// once; one side is coalesced, the other scattered (the store in the
// forward, the load in the inverse).  A scattered access of 4 bytes costs
// an L2 transaction all the same as one of 16, so the payloads of one
// element size travel together as the columns of one table: with four
// float32 payloads one 16-byte access replaces four 4-byte ones.  A row
// moves in its widest aligned words (16, 8, 4, 2 or 1 bytes).  Of the two
// ways to run a forward permutation, a scatter by the rank and a gather by
// its inverse (this kernel's inverse mode), the gather was the faster on
// an H100 at every size timed (PERF.md): its stores are coalesced, and its
// scattered loads are independent, so the card keeps many in flight.  The
// callers on the training paths hold the inverse rank (the banded
// layouts, the composite pull-to-push rank) and run every permutation as
// a gather.  The scatter stays for apply_fixed_perm, whose contract (JAX's)
// gives the rank alone: building its inverse would itself be a scatter by
// the rank.  A rank outside [0, m) is skipped (forward) or reads as zeros
// (inverse), so a bad rank cannot write out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int B> struct Word;
template <> struct Word<1> { using T = uint8_t; };
template <> struct Word<2> { using T = uint16_t; };
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<16> { using T = uint4; };

// rows of `words` words of B bytes
template <int B, bool kInverse>
__global__ void __launch_bounds__(kThreads)
permute_kernel(const int* __restrict__ rank, const void* __restrict__ in_,
               void* __restrict__ out_, long long words, long long m) {
  using T = typename Word<B>::T;
  const T* in = static_cast<const T*>(in_);
  T* out = static_cast<T*>(out_);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < m; i += stride) {
    const long long r = rank[i];
    const bool ok = r >= 0 && r < m;
    if (kInverse) {
      for (long long w = 0; w < words; ++w)
        out[i * words + w] = ok ? in[r * words + w] : T{};
    } else if (ok) {
      for (long long w = 0; w < words; ++w)
        out[r * words + w] = in[i * words + w];
    }
  }
}

template <int B>
int launch(const int* rank, const void* in, void* out, long long words,
           long long m, int inverse, cudaStream_t s) {
  // enough blocks to fill the card several times over; the grid-stride
  // loop takes the rest
  const long long want = (m + kThreads - 1) / kThreads;
  const unsigned blocks =
      static_cast<unsigned>(want < 132 * 64 ? want : 132 * 64);
  if (inverse)
    permute_kernel<B, true><<<blocks, kThreads, 0, s>>>(rank, in, out, words,
                                                        m);
  else
    permute_kernel<B, false><<<blocks, kThreads, 0, s>>>(rank, in, out,
                                                         words, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rank: int32 [m] on the device; in, out: [m, words x word] bytes on it,
// out never aliasing in; word, the bytes of one access: 1, 2, 4, 8 or 16,
// dividing both addresses.  Returns cudaGetLastError() after the launch (0
// on success), or cudaErrorInvalidValue for bad arguments.
extern "C" int permute_launch(const void* rank, const void* in, void* out,
                              int word, long long words, long long m,
                              int inverse, void* stream) {
  if (words < 1 || m < 0 || m > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rank);
  switch (word) {
    case 1: return launch<1>(r, in, out, words, m, inverse, s);
    case 2: return launch<2>(r, in, out, words, m, inverse, s);
    case 4: return launch<4>(r, in, out, words, m, inverse, s);
    case 8: return launch<8>(r, in, out, words, m, inverse, s);
    case 16: return launch<16>(r, in, out, words, m, inverse, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
