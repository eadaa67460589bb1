// Contiguous-segment reduce:
//   out[v, h] = ident (op) op_k op_{j in [offs_k[v], offs_k[v+1])} vals_k[j, h]
// op in {min, max, sum, bor}, on int32 and float32 (bor on int32 only),
// over K segment-sorted value streams vals_k [m_k, H] (row-major, H in
// 1..8) with K offset arrays offs_k [n + 1]; rows at or past offs_k[n]
// belong to no segment.  A segment with no value in any stream gets the
// identity the caller passes.  K = 1, H = 1 is the engine's per-vertex
// reduce (ops/engine.reduce_csc_by_dst and reduce_csr_by_src): the
// or-reduce of every BFS advance and the min of the BFS predecessor pass;
// K = 1, H > 1 reduces [m, H] edge values column by column in one launch;
// K > 1 is GAT's per-head score cotangent summed off the K bands of a
// banded layout (ops/spmm.banded_heads_segment_sum), bands combined in
// order 0..K-1.
//
// Replaces the TPU kernel mini_tpu/ops/pallas/segreduce_kernel.py,
// segment_reduce_pallas (kernel body _segreduce_kernel).
//
// What bounds it on an H100: bytes.  Each value is read once (4 B) and
// combined once, about 0.25 operations per byte, far below the ~295
// operations per byte at which the card stops being memory-bound.  At
// rmat16 (2.1M values, 65,536 segments) that is 8.9 MB, 2.7 us at 3.35
// TB/s: the same order as an empty kernel's launch (1.3-1.6 us in a CUDA
// graph), so the number of launches matters as much as the kernel.
//
// The first form gave one warp one whole segment, a 4-byte load a lane:
// the rmat16 hub (25,801 values) and the ghost segment of pad edges ran
// ~800 trips on one warp, the 65,535 other segments cost two dependent
// loads and a mostly idle warp each, and [m, H] values or K bands took a
// launch and a strided copy per column and band (24 launches a GAT step).
// It took 0.018 ms at rmat16, 15% of the bound (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md).  The design now balances values, not segments
// (moderngpu's lbs_segreduce, as gunrock's neighborhood reduce uses it):
// - Each stream is cut into chunks of 32 E rows, one chunk a warp (the
//   walker), E rows a lane: E H = 16 values for H = 1, 2, 4, 8, else E = 4.
//   A lane reads its E H contiguous values with 16-byte streaming loads,
//   all started before anything waits on them.
// - What a walker waits for is a chain of dependent loads, so the chain is
//   kept short.  The segments of the chunk's first and last row are read
//   from the rows' segment ids, which every caller has (the engine's dsts,
//   a banded layout's seg; two 4-byte loads a chunk, not the array: a
//   search of the offsets by the warp, 3 rounds of coalesced probes, was
//   built first and measured 10-40% slower).  The offsets between
//   the two, one coalesced load, are the segment begins inside the chunk:
//   each goes into a map of the chunk's rows in shared memory (atomicMax,
//   so the last of several segments that begin at one row wins: the others
//   are empty), and a lane reads its own E entries back.  The segment of a
//   lane's first row is the last begin before it, a running maximum over
//   the lanes.  No lane searches, and the fold below loads nothing.  A
//   chunk that spans more than 1024 segments (a run of empty ones inside
//   it: the star graph's ghost lies 100K empty segments past its hub) has
//   its lanes search the offsets instead.
// - A lane folds its rows in order, one run per segment.  A run that
//   begins and ends inside the lane is a whole segment and is stored at
//   once.  The lane's last run goes into a segmented scan over the 32
//   lanes (5 shuffle steps a column), which joins the runs of a segment
//   that spans lanes; the lane's first run, if another follows it, closes
//   its segment with the scan's value of the lane before.
// - A segment that lies inside one chunk is stored by its walker.  One
//   that crosses a chunk edge leaves its part in a carry buffer [chunks,
//   2, H]: side 0 for a segment that began before the chunk, side 1 for
//   one that goes on past it.
// - A second, small launch (the fix-up, a thread a segment) finishes:
//   it gives the identity to a segment with no value, folds the carries
//   of a segment that crosses chunks (the warp's lanes stride over them
//   and fold by shuffles, so the star graph's 99,999-value segment is 195
//   carries on 32 lanes), combines the K bands in order and applies the
//   caller's identity.
// - No atomics on values: every output is written once, and the float32
//   sum takes one fixed order, that of segment_reduce_scheduled_plain
//   (ops/kernels/segreduce_kernel.py), which reproduces the kernel bit for
//   bit.  min, max, bor and the int32 sum (taken in unsigned arithmetic,
//   so it wraps like the reference) equal any other order bitwise.
// Measured (NVIDIA H100 80GB HBM3, 700 W, both launches, chip_smoke.py,
// two runs): rmat16 [2.1M] 0.010-0.012 ms (23-27% of the bound; the walker
// 0.0068, the fix-up 0.0031), [2.1M, 2] 0.014-0.017 (31-39%), [2.1M, 8]
// 0.042-0.046 (45-50%), rmat18 [8.4M] 0.027-0.029 (37-39%), the star graph
// 0.010-0.011, the K = 3, H = 2 bands of GAT 0.017-0.019 where a launch
// per band and column took 0.070-0.083.  Without the map and the segment
// ids (a 32-ary search, then a binary search a lane and the offsets read
// in the fold) the same cases took 0.013, 0.017-0.019, 0.045-0.047,
// 0.037-0.038 and 0.023 ms.
// The walker holds 64 registers (nvcc -Xptxas -v), 4 blocks an SM; held
// to the registers of 5, 6 or 8 blocks it spills and measured slower.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum { OP_MIN = 0, OP_MAX = 1, OP_SUM = 2, OP_BOR = 3 };
enum { DT_INT32 = 0, DT_FLOAT32 = 1 };

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int kWalkBlocks = 4;  // walker blocks an SM holds, at least
constexpr int kMaxBands = 128;
constexpr int kMaxCols = 8;
constexpr int kRowSteps = 4;  // empty segments stepped over before a search
// A chunk whose rows span at most this many segments finds them through a
// map in shared memory; more (a run of empty segments inside the chunk)
// and its lanes search the offsets.
constexpr int kMapSegments = 1024;
constexpr unsigned kFull = 0xffffffffu;

// Rows a lane folds: 16 values for 1, 2, 4 or 8 columns, else 4 rows (a
// whole number of 16-byte loads either way).
__host__ __device__ constexpr int rows_per_lane(int H) {
  return (H & (H - 1)) == 0 ? 16 / H : 4;
}

// The K streams travel by value in the kernels' parameters.
struct Bands {
  const int* offs[kMaxBands];    // [n + 1] segment offsets of stream k
  const void* vals[kMaxBands];   // [rows[k], H]
  const int* segs[kMaxBands];    // [rows[k]] the segment of every row
  int rows[kMaxBands];           // rows of stream k's tensor
  int first_chunk[kMaxBands + 1];  // chunks of the streams before k
};

template <typename T>
__device__ __forceinline__ T combine(int op, T a, T b) {
  switch (op) {
    case OP_MIN: return b < a ? b : a;
    case OP_MAX: return b > a ? b : a;
    case OP_SUM:
      if constexpr (std::is_integral_v<T>) {
        // int32: wrapping sum without signed-overflow UB
        return static_cast<T>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
      } else {
        return a + b;
      }
    default:
      if constexpr (std::is_integral_v<T>) return a | b;
      else return a;  // bor is refused for float32 at the entry
  }
}

// The value that changes nothing under op.
template <typename T>
__device__ __forceinline__ T neutral(int op) {
  if constexpr (std::is_integral_v<T>) {
    return op == OP_MIN ? INT_MAX : op == OP_MAX ? INT_MIN : 0;
  } else {
    return op == OP_MIN ? __int_as_float(0x7f800000)    // +inf
         : op == OP_MAX ? __int_as_float(0xff800000)    // -inf
                        : 0.0f;
  }
}

template <typename T> __device__ __forceinline__ T from_bits(int b);
template <> __device__ __forceinline__ int from_bits<int>(int b) { return b; }
template <> __device__ __forceinline__ float from_bits<float>(int b) {
  return __int_as_float(b);
}

template <typename T> __device__ __forceinline__ int to_bits(T v);
template <> __device__ __forceinline__ int to_bits<int>(int v) { return v; }
template <> __device__ __forceinline__ int to_bits<float>(float v) {
  return __float_as_int(v);
}

template <typename T>
__device__ __forceinline__ T shfl_up(T v, int d) {
  return from_bits<T>(__shfl_up_sync(kFull, to_bits(v), d));
}
template <typename T>
__device__ __forceinline__ T shfl_xor(T v, int o) {
  return from_bits<T>(__shfl_xor_sync(kFull, to_bits(v), o));
}

// Last index i in [lo, hi] with a[i] <= v, for a non-decreasing a with
// a[lo] <= v.
__device__ __forceinline__ int last_le(const int* a, int lo, int hi, int v) {
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    if (a[mid] <= v) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// From segment cur, which ends at or before row p, to the segment that
// holds p: empty segments are stepped over one by one for a few, then by
// binary search (the star graph's ghost segment lies 100K empty segments
// past its hub).
__device__ __forceinline__ int segment_of(const int* offs, int n, int cur,
                                          int p) {
  ++cur;
  for (int i = 0; i < kRowSteps && offs[cur + 1] <= p; ++i) ++cur;
  if (offs[cur + 1] <= p) cur = last_le(offs, cur, n - 1, p);
  return cur;
}

// A chunk's walker: warp w folds rows [start, stop) of its stream (see the
// header).  part: [K, n, H], a segment's value within stream k, written
// for the segments that lie inside one chunk.  carry: [n_chunks, 2, H].
template <typename T, int H>
__global__ void __launch_bounds__(kThreads, kWalkBlocks)
segreduce_walk_kernel(const __grid_constant__ Bands bands, int K, int n,
                      int op, T* __restrict__ part, T* __restrict__ carry,
                      int n_chunks) {
  constexpr int E = rows_per_lane(H), C = kWarp * E, NV = E * H / 4;
  const int lane = threadIdx.x % kWarp;
  const int w = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (w >= n_chunks) return;
  int k = 0;
  while (k + 1 < K && bands.first_chunk[k + 1] <= w) ++k;
  const int* offs = bands.offs[k];
  const T* vals = static_cast<const T*>(bands.vals[k]);
  const long long first = static_cast<long long>(w - bands.first_chunk[k]) * C;
  const int start = static_cast<int>(first);
  const int pos = start + lane * E;  // this lane's first row
  const T zero = neutral<T>(op);

  // Three things wait on memory and none on another: the lane's E H
  // values (whatever lies inside the tensor: rows past the chunk's end
  // are loaded and not used), the stream's real length, and the segments
  // of the chunk's first and last row.
  T v[E * H];
  const size_t flat = static_cast<size_t>(pos) * H;
  const size_t limit = static_cast<size_t>(bands.rows[k]) * H;
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    const size_t i0 = flat + 4 * q;
    if (i0 + 4 <= limit) {
      const int4 r = __ldcs(reinterpret_cast<const int4*>(vals + i0));
      v[4 * q] = from_bits<T>(r.x);
      v[4 * q + 1] = from_bits<T>(r.y);
      v[4 * q + 2] = from_bits<T>(r.z);
      v[4 * q + 3] = from_bits<T>(r.w);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[4 * q + i] = i0 + i < limit ? vals[i0 + i] : zero;
    }
  }
  const int total = min(offs[n], bands.rows[k]);  // the stream's real rows
  // the segments of the chunk's first and last row, read from the rows'
  // segment ids
  const int* ids = bands.segs[k];
  const int target = min(start + C, bands.rows[k]) - 1;
  const int v_first = ids[start];
  int v_last = ids[target];
  if (first >= total) return;  // the same for the whole warp
  const int stop = min(start + C, total);
  if (stop - 1 != target) v_last = ids[stop - 1];  // a stream's last chunk
  // where the first segment begins and the last one ends decides, below,
  // whether a segment lies inside this chunk
  const int first_from = offs[v_first], last_to = offs[v_last + 1];
  const bool active = pos < stop;
  const int lane_end = min(pos + E, stop);

  // seg[r]: the segment that begins at this lane's row r > 0, or -1; cur0:
  // the segment of its row 0.
  int seg[E], cur0;
  if (v_last - v_first <= kMapSegments) {
    // Every segment begin in the chunk goes into a map of its rows in
    // shared memory (the last of the segments that begin at one row: the
    // others are empty), read back by the lane that owns the row.
    __shared__ __align__(16) int maps[kWarpsPerBlock][C];
    int* map = maps[threadIdx.x / kWarp];
    for (int i = lane; i < C / 4; i += kWarp)
      reinterpret_cast<int4*>(map)[i] = make_int4(-1, -1, -1, -1);
    __syncwarp();
    for (int s = v_first + 1 + lane; s <= v_last; s += kWarp)
      atomicMax(&map[offs[s] - start], s);  // start < offs[s] < stop
    __syncwarp();
    int last = -1;  // the last begin among this lane's rows
    if constexpr (E % 4 == 0) {
#pragma unroll
      for (int q = 0; q < E / 4; ++q) {
        const int4 t = reinterpret_cast<const int4*>(map + lane * E)[q];
        seg[4 * q] = t.x;
        seg[4 * q + 1] = t.y;
        seg[4 * q + 2] = t.z;
        seg[4 * q + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int r = 0; r < E; ++r) seg[r] = map[lane * E + r];
    }
#pragma unroll
    for (int r = 0; r < E; ++r) last = max(last, seg[r]);
    // the last begin before this lane's rows: a running maximum over the
    // lanes before it
#pragma unroll
    for (int d = 1; d < kWarp; d *= 2) {
      const int up = __shfl_up_sync(kFull, last, d);
      if (lane >= d) last = max(last, up);
    }
    const int before = __shfl_up_sync(kFull, last, 1);
    cur0 = seg[0] >= 0 ? seg[0] : lane > 0 && before >= 0 ? before : v_first;
  } else {
    cur0 = active ? last_le(offs, v_first, v_last, pos) : v_last;
    int cur = cur0, next = offs[cur + 1];
    seg[0] = -1;
#pragma unroll
    for (int r = 1; r < E; ++r) {
      seg[r] = -1;
      const int p = pos + r;
      if (p < lane_end && p >= next) {
        cur = seg[r] = segment_of(offs, n, cur, p);
        next = offs[cur + 1];
      }
    }
  }

  T* mine = part + static_cast<size_t>(k) * n * H;
  T acc[H], head[H];
#pragma unroll
  for (int h = 0; h < H; ++h) acc[h] = head[h] = zero;
  int runs = 0, head_seg = -1, cur = cur0;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    if (pos + r < lane_end) {
      if (r > 0 && seg[r] >= 0) {  // the run of segment cur ends before r
        if (runs == 0) {
          head_seg = cur;
#pragma unroll
          for (int h = 0; h < H; ++h) head[h] = acc[h];
        } else {  // it began in this lane too: a whole segment
#pragma unroll
          for (int h = 0; h < H; ++h)
            mine[static_cast<size_t>(cur) * H + h] = acc[h];
        }
        ++runs;
#pragma unroll
        for (int h = 0; h < H; ++h) acc[h] = zero;
        cur = seg[r];
      }
#pragma unroll
      for (int h = 0; h < H; ++h) acc[h] = combine(op, acc[h], v[r * H + h]);
    }
  }

  // the lanes' last runs, joined where a segment spans lanes
  const int key = active ? cur : -1;
  const int first_seg = !active ? -1 : runs > 0 ? head_seg : cur;
#pragma unroll
  for (int d = 1; d < kWarp; d *= 2) {
    const bool join = __shfl_up_sync(kFull, key, d) == key && lane >= d;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const T up = shfl_up(acc[h], d);
      if (join) acc[h] = combine(op, up, acc[h]);
    }
  }
  const int prev_key = __shfl_up_sync(kFull, key, 1);
  const int next_first = __shfl_down_sync(kFull, first_seg, 1);
  T before[H];
#pragma unroll
  for (int h = 0; h < H; ++h) before[h] = shfl_up(acc[h], 1);

  // a finished segment's value: to part when the segment lies inside this
  // chunk, else to the chunk's carry (side 0: it began before the chunk)
  const auto emit = [&](int sg, const T (&x)[H]) {
    const bool began_before = sg == v_first && first_from < start;
    const bool ends_inside = sg < v_last || last_to <= stop;
    T* dst = !began_before && ends_inside
                 ? mine + static_cast<size_t>(sg) * H
                 : carry + (static_cast<size_t>(w) * 2 +
                            (began_before ? 0 : 1)) * H;
#pragma unroll
    for (int h = 0; h < H; ++h) dst[h] = x[h];
  };
  if (runs > 0) {  // the first run closes its segment here
    if (lane > 0 && prev_key == head_seg) {
#pragma unroll
      for (int h = 0; h < H; ++h) head[h] = combine(op, before[h], head[h]);
    }
    emit(head_seg, head);
  }
  if (active && (lane == kWarp - 1 || next_first != key)) emit(key, acc);
}

// The fix-up, a thread a segment: per stream, a segment's value is none
// (no row), its walker's (it lies inside one chunk) or its carries folded:
// side 1 of its first chunk, then side 0 of the later ones, which the
// warp's lanes stride over and fold by shuffles.  The streams' values are
// combined in order, then the identity; every out[v, :] is written here.
// part may be out (K = 1): a thread reads its own entry before it writes.
template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
segreduce_fixup_kernel(const __grid_constant__ Bands bands, int K, int n,
                       int op, T ident, const T* part,
                       const T* __restrict__ carry, T* out) {
  constexpr int C = kWarp * rows_per_lane(H);
  const int lane = threadIdx.x % kWarp;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const bool in = v < n;  // every lane stays for the shuffles
  const T zero = neutral<T>(op);
  T tot[H];
#pragma unroll
  for (int h = 0; h < H; ++h) tot[h] = zero;
  for (int k = 0; k < K; ++k) {
    const int* offs = bands.offs[k];
    const int s = in ? offs[v] : 0, e = in ? offs[v + 1] : 0;
    const int b0 = s / C, b1 = e > s ? (e - 1) / C : b0;
    // the walker's value, read before it is known to be one: a segment
    // that is empty or crosses chunks has none, and what lies there is
    // not used
    T x[H];
    const T* p = part + (static_cast<size_t>(k) * n + (in ? v : 0)) * H;
#pragma unroll
    for (int h = 0; h < H; ++h) x[h] = p[h];
    unsigned crossing = __ballot_sync(kFull, b1 > b0);
    while (crossing) {  // one segment that crosses chunks at a time
      const int src = __ffs(crossing) - 1;
      crossing &= crossing - 1;
      const int c0 = bands.first_chunk[k] + __shfl_sync(kFull, b0, src);
      const int c1 = bands.first_chunk[k] + __shfl_sync(kFull, b1, src);
      T fold[H];
#pragma unroll
      for (int h = 0; h < H; ++h) fold[h] = zero;
      for (int b = c0 + 1 + lane; b <= c1; b += kWarp) {
#pragma unroll
        for (int h = 0; h < H; ++h)
          fold[h] = combine(op, fold[h],
                            carry[static_cast<size_t>(b) * 2 * H + h]);
      }
#pragma unroll
      for (int o = kWarp / 2; o > 0; o /= 2) {
#pragma unroll
        for (int h = 0; h < H; ++h)
          fold[h] = combine(op, fold[h], shfl_xor(fold[h], o));
      }
      if (lane == src) {
#pragma unroll
        for (int h = 0; h < H; ++h)
          x[h] = combine(
              op, carry[(static_cast<size_t>(c0) * 2 + 1) * H + h], fold[h]);
      }
    }
    if (e > s) {
#pragma unroll
      for (int h = 0; h < H; ++h) tot[h] = combine(op, tot[h], x[h]);
    }
  }
  if (in) {
#pragma unroll
    for (int h = 0; h < H; ++h)
      out[static_cast<size_t>(v) * H + h] = combine(op, ident, tot[h]);
  }
}

__global__ void empty_kernel() {}

struct Args {
  Bands bands;
  int K, n, op, n_chunks;
  void *out, *part, *carry;
  cudaStream_t stream;
};

template <typename T, int H>
void launch(const Args& a, T ident) {
  T* part = static_cast<T*>(a.part);
  T* carry = static_cast<T*>(a.carry);
  if (a.n_chunks > 0) {
    const int blocks = (a.n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
    segreduce_walk_kernel<T, H><<<blocks, kThreads, 0, a.stream>>>(
        a.bands, a.K, a.n, a.op, part, carry, a.n_chunks);
  }
  segreduce_fixup_kernel<T, H>
      <<<(a.n + kThreads - 1) / kThreads, kThreads, 0, a.stream>>>(
          a.bands, a.K, a.n, a.op, ident, part, carry,
          static_cast<T*>(a.out));
}

// launch<T, cols> for cols in [H, kMaxCols]
template <typename T, int H>
void launch_cols(const Args& a, T ident, int cols) {
  if (cols == H) {
    launch<T, H>(a, ident);
  } else if constexpr (H < kMaxCols) {
    launch_cols<T, H + 1>(a, ident, cols);
  }
}

}  // namespace

extern "C" int segreduce_max_bands() { return kMaxBands; }

// offs_ptrs, val_ptrs, rows: host arrays of K device pointers to the
// offsets (int32 [n + 1]) and the values ([rows[k], H], 16-byte aligned)
// and the K row counts.  seg_ptrs: K device pointers to the segment of
// every row of stream k (int32 [rows[k]], the ids the offsets give; rows
// at or past offs_k[n] hold anything; null for a stream of no rows): a
// walker reads its chunk's first and last segment there.  out: [n, H].  part: scratch [K, n, H]; for K = 1
// it may be out itself.  carry: scratch [n_chunks, 2, H], n_chunks = sum_k
// ceil(rows[k] / (32 rows_per_lane(H))).  Two launches: the walkers,
// then the fix-up.  Returns cudaGetLastError() after them (0 on success),
// or cudaErrorInvalidValue for bad arguments.
extern "C" int segreduce_bands_launch(const void* const* offs_ptrs,
                                      const void* const* seg_ptrs,
                                      const void* const* val_ptrs,
                                      const long long* rows, int K, int n,
                                      int H, int dtype, int op,
                                      double ident_f, long long ident_i,
                                      void* out, void* part, void* carry,
                                      int n_chunks, void* stream) {
  if (K < 1 || K > kMaxBands || n < 0 || H < 1 || H > kMaxCols ||
      op < OP_MIN || op > OP_BOR ||
      (dtype != DT_INT32 && dtype != DT_FLOAT32) ||
      (dtype == DT_FLOAT32 && op == OP_BOR))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Args a = {};
  const int C = kWarp * rows_per_lane(H);
  for (int k = 0; k < K; ++k) {
    if (rows[k] < 0 || rows[k] > INT_MAX ||
        (rows[k] > 0 && seg_ptrs[k] == nullptr) ||
        reinterpret_cast<uintptr_t>(val_ptrs[k]) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    a.bands.offs[k] = static_cast<const int*>(offs_ptrs[k]);
    a.bands.vals[k] = val_ptrs[k];
    a.bands.segs[k] = static_cast<const int*>(seg_ptrs[k]);
    a.bands.rows[k] = static_cast<int>(rows[k]);
    a.bands.first_chunk[k + 1] =
        a.bands.first_chunk[k] + static_cast<int>((rows[k] + C - 1) / C);
  }
  if (a.bands.first_chunk[K] != n_chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  a.K = K;
  a.n = n;
  a.op = op;
  a.n_chunks = n_chunks;
  a.out = out;
  a.part = part;
  a.carry = carry;
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == DT_INT32) {
    launch_cols<int, 1>(a, static_cast<int>(ident_i), H);
  } else {
    launch_cols<float, 1>(a, static_cast<float>(ident_f), H);
  }
  return static_cast<int>(cudaGetLastError());
}

// One stream: the same with K = 1 and out as its own scratch.  dsts: the
// segment of every row (seg_ptrs[0] above).
extern "C" int segreduce_launch(const void* offsets, const void* dsts,
                                const void* vals, long long rows, int n,
                                int H, int dtype, int op, double ident_f,
                                long long ident_i, void* out, void* carry,
                                int n_chunks, void* stream) {
  return segreduce_bands_launch(&offsets, &dsts, &vals, &rows, 1, n, H, dtype,
                                op, ident_f, ident_i, out, out, carry,
                                n_chunks, stream);
}

// A kernel that does nothing, one block of one warp: the floor under any
// launch's device time.  Returns cudaGetLastError().
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
