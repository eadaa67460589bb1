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
//
// The same one-band launch (K = 1, bounds = offsets[::128], offs2d =
// offsets[:-1]) is the Hopper form of mini_tpu/ops/pallas/spmm_kernel.py,
// segment_sum_pallas: a CSC segment sum is a banded layout with one band.
//
// Banded SDDMM, the second entry point below:
//   dw[base_k + j] = <y[dst(k, j), :], msgs[k][j, :]>
// for every slot j < bounds[k, n_tiles] of band k, where dst(k, j) is the
// row whose staircase segment holds j; slots past the band's end are 0.
// It replaces mini_tpu/ops/pallas/spmm_banded.py, banded_sddmm.  The TPU
// kernel walks 128-row output tiles and multiplies each 512-edge chunk
// against the tile on the MXU, with a "pure chunk" path and a
// read-modify-write of chunks that straddle two tiles, all of it because
// its grid runs in order on one core.  Here the output is per slot, so the
// kernel is edge-parallel: one warp owns 32 consecutive slots of one band,
// finds the first slot's row by binary search (over bounds[k, :], then
// over offs2d[t, k, :]) and walks forward.  Each lane holds columns
// lane, lane + 32, ... of the current y row in registers, reloaded only
// when the segment changes; a slot's dot product is a warp-shuffle sum.
// Every slot is written exactly once, with no atomics: deterministic, and
// a hub row spreads over as many warps as it has runs of 32 slots.
// Bound by bytes like the sum: each message row is read once (y rows come
// from cache), 2 operations per 4 bytes of float32 message.
//
// With H heads (GAT's weight cotangent) a slot gets H dot products,
// dw[base_k + j, h] over columns [h F/H, (h+1) F/H): the warp walks its 32
// slots once per head, over that head's columns only, so each message byte
// is still read once and no head is padded or copied (the TPU twin pads
// each head to 128 lanes and runs H passes).  H = 1 is the form above,
// with the same order of operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowTile = 128;
constexpr int kCols = 32;      // columns per block (threadIdx.x)
constexpr int kRowGroups = 8;  // warps per block (threadIdx.y)
constexpr int kMaxBands = 128;
constexpr int kWarp = 32;
constexpr int kSlotsPerWarp = 32;  // one output slot per lane
constexpr int kSddmmWarps = 8;     // warps per block of the SDDMM
constexpr int kColsPerLane = 8;    // y values a lane keeps in registers
constexpr int kColBlock = kWarp * kColsPerLane;  // columns per pass

enum { DT_FLOAT32 = 0, DT_BFLOAT16 = 1 };

// The K stream pointers travel by value in the kernel's parameters.
struct StreamPtrs {
  const void* p[kMaxBands];
};

// Flat slot index of each band's first slot; base[K] is the total.
struct StreamBases {
  long long b[kMaxBands + 1];
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

// Last index i in [0, n) with a[i] <= v, for a non-decreasing a with
// a[0] <= v.
__device__ __forceinline__ int last_le(const int* a, int n, int v) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a[mid] <= v) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <typename TM, typename TY>
__global__ void __launch_bounds__(kWarp * kSddmmWarps)
banded_sddmm_kernel(StreamPtrs msgs, StreamBases base,
                    const int* __restrict__ bounds,
                    const int* __restrict__ offs2d,
                    const TY* __restrict__ y, float* __restrict__ out, int K,
                    int n_tiles, int F, int H, long long n_runs) {
  const int lane = threadIdx.x % kWarp;
  const long long run =
      static_cast<long long>(blockIdx.x) * kSddmmWarps + threadIdx.x / kWarp;
  if (run >= n_runs) return;
  const long long s0 = run * kSlotsPerWarp;  // flat slot of lane 0
  int k = 0;
  while (k + 1 < K && base.b[k + 1] <= s0) ++k;
  const int j0 = static_cast<int>(s0 - base.b[k]);
  const int* bk = bounds + static_cast<size_t>(k) * (n_tiles + 1);
  const int end = bk[n_tiles];  // the band's real slots are [0, end)
  const int j1 = min(j0 + kSlotsPerWarp, end);
  // the segment (tile t0, row r0) holding slot j0; its end is > j0
  int t0 = 0, r0 = 0;
  if (j0 < end) {
    t0 = last_le(bk, n_tiles, j0);
    r0 = last_le(offs2d + (static_cast<size_t>(t0) * K + k) * kRowTile,
                 kRowTile, j0);
  }
  const TM* m = static_cast<const TM*>(msgs.p[k]);
  const int d = F / H;  // head h dots columns [h d, (h + 1) d)
  for (int h = 0; h < H; ++h) {
    const int c_end = (h + 1) * d;
    float acc = 0.0f;  // lane s accumulates slot j0 + s
    for (int c0 = h * d; c0 < c_end && j0 < end; c0 += kColBlock) {
      int t = t0, r = r0, row = -1;
      float yv[kColsPerLane];
      auto seg_end = [&](int tt, int rr) {
        return rr + 1 < kRowTile
                   ? offs2d[(static_cast<size_t>(tt) * K + k) * kRowTile +
                            rr + 1]
                   : bk[tt + 1];
      };
      int next = seg_end(t, r);
      for (int j = j0; j < j1; ++j) {
        while (j >= next) {  // skip to the segment that holds j
          if (++r == kRowTile) {
            r = 0;
            ++t;
          }
          next = seg_end(t, r);
        }
        const int v = t * kRowTile + r;
        if (v != row) {  // a new segment: its y row into registers
          row = v;
          const TY* yr = y + static_cast<size_t>(v) * F;
#pragma unroll
          for (int i = 0; i < kColsPerLane; ++i) {
            const int c = c0 + lane + i * kWarp;
            yv[i] = c < c_end ? to_f32(yr[c]) : 0.0f;
          }
        }
        const TM* mj = m + static_cast<size_t>(j) * F;
        float p = 0.0f;
#pragma unroll
        for (int i = 0; i < kColsPerLane; ++i) {
          const int c = c0 + lane + i * kWarp;
          if (c < c_end) p += yv[i] * to_f32(mj[c]);
        }
#pragma unroll
        for (int o = kWarp / 2; o > 0; o /= 2)
          p += __shfl_xor_sync(0xffffffffu, p, o);
        if (lane == j - j0) acc += p;
      }
    }
    out[(s0 + lane) * H + h] = acc;
  }
}

template <typename TM, typename TY>
void launch_sddmm(const StreamPtrs& ptrs, const StreamBases& bases,
                  const int* b, const int* o, const void* y, float* out,
                  int K, int n_tiles, int F, int H, long long n_runs,
                  cudaStream_t s) {
  const long long blocks = (n_runs + kSddmmWarps - 1) / kSddmmWarps;
  banded_sddmm_kernel<TM, TY>
      <<<static_cast<unsigned>(blocks), kWarp * kSddmmWarps, 0, s>>>(
          ptrs, bases, b, o, static_cast<const TY*>(y), out, K, n_tiles, F,
          H, n_runs);
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

// msg_ptrs, lens: host arrays of K device pointers and K stream lengths
// (each a multiple of 32).  H: heads, dividing F.  out: float32
// [sum(lens), H].  msg_dtype, y_dtype: DT_FLOAT32 or DT_BFLOAT16.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for bad arguments.
extern "C" int banded_sddmm_launch(const void* const* msg_ptrs,
                                   const long long* lens, int K,
                                   const void* bounds, const void* offs2d,
                                   const void* y, void* out, int n_tiles,
                                   int F, int H, int msg_dtype, int y_dtype,
                                   void* stream) {
  const auto dtype_ok = [](int d) {
    return d == DT_FLOAT32 || d == DT_BFLOAT16;
  };
  if (K < 1 || K > kMaxBands || n_tiles < 1 || F < 1 || H < 1 || F % H ||
      !dtype_ok(msg_dtype) || !dtype_ok(y_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  StreamPtrs ptrs = {};
  StreamBases bases = {};
  for (int k = 0; k < K; ++k) {
    if (lens[k] < 0 || lens[k] % kSlotsPerWarp)
      return static_cast<int>(cudaErrorInvalidValue);
    ptrs.p[k] = msg_ptrs[k];
    bases.b[k + 1] = bases.b[k] + lens[k];
  }
  const long long n_runs = bases.b[K] / kSlotsPerWarp;
  if (n_runs == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* b = static_cast<const int*>(bounds);
  const int* o = static_cast<const int*>(offs2d);
  float* dw = static_cast<float*>(out);
  const int code = msg_dtype * 2 + y_dtype;
  if (code == DT_FLOAT32 * 2 + DT_FLOAT32) {
    launch_sddmm<float, float>(ptrs, bases, b, o, y, dw, K, n_tiles, F,
                               H, n_runs, s);
  } else if (code == DT_FLOAT32 * 2 + DT_BFLOAT16) {
    launch_sddmm<float, __nv_bfloat16>(ptrs, bases, b, o, y, dw, K, n_tiles,
                                       F, H, n_runs, s);
  } else if (code == DT_BFLOAT16 * 2 + DT_FLOAT32) {
    launch_sddmm<__nv_bfloat16, float>(ptrs, bases, b, o, y, dw, K, n_tiles,
                                       F, H, n_runs, s);
  } else {
    launch_sddmm<__nv_bfloat16, __nv_bfloat16>(ptrs, bases, b, o, y, dw, K,
                                               n_tiles, F, H, n_runs, s);
  }
  return static_cast<int>(cudaGetLastError());
}
