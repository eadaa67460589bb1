// Banded segment sum, the core of every sum-SpMM:
//   out[v, :] = sum_k sum_{j in [offs2d[t,k,r], next)} w[k][j] * msgs[k][j, :]
// for v = 128 t + r, where next = offs2d[t,k,r+1], or bounds[k,t+1] for
// r = 127.  K segment-sorted message streams msgs[k] ([mk_pad, F], float32
// or bfloat16) fold into one float32 output [n_tiles * 128, F].  Pad slots
// past a band's last segment end are never read.  The messages come in
// one of two forms.  The stream form reads them from K gathered streams.
// The indexed form reads msgs[k][j] = x[k band_rows + ids[k][j]] from the
// source table x ([n_src, F]) by the layout's K band-local id streams, so
// no gathered copy is written or read back.  The weights are
// optional: without them w[k][j] = 1 and nothing is multiplied.  With
// them, w[k] is [mk_pad] of the messages' type, or [mk_pad, H] for H heads
// (GAT), column c of a message taking head c / (F / H)'s weight.  A
// weighted message is formed as _weigh in ops/spmm.py forms it: one
// product in float32 (__fmul_rn, never contracted into an FMA) rounded to
// the message's type, then added in float32, so the sum has the bits of
// the unweighted sum of _weigh's weighted copy, which is never written.
//
// Replaces the TPU kernel mini_tpu/ops/pallas/spmm_banded.py,
// banded_segment_sum.  The TPU version builds a one-hot "staircase" per
// 512-edge chunk and multiplies it on the matrix unit, with a bf16 hi/lo
// split for float32 and double-buffered DMA; none of that carries over.
// The same one-band launch (K = 1, bounds = offsets[::128], offs2d =
// offsets[:-1]) is the Hopper form of mini_tpu/ops/pallas/spmm_kernel.py,
// segment_sum_pallas: a CSC segment sum is a banded layout with one band.
//
// What bounds it on an H100: bytes.  Every message element is read once
// and added once: 0.25 adds per byte in float32 (0.5 in bf16), far below
// the ~295 operations per byte at which the card stops being memory-bound.
// At rmat16, K = 3, F = 128 float32 it reads 1.074 GB of messages and
// writes 33.6 MB: 0.331 ms at 3.35 TB/s.  The weights add 4 bytes a slot
// (0.8% at F = 128) and one multiply a message element.  Taking them here
// saves a read and a write of every stream: multiplying first writes a
// weighted copy that this kernel then reads.
//
// Why the first schedule missed that bound.  A block owned one 128-row
// tile and each thread one output element, walking its row's segments one
// 4-byte load after another.  The rmat16 hub has 25,801 in-edges (13,031
// in one band), so its threads ran ~25.8K dependent adds long after every
// other tile had finished: 2.95 ms whatever the bytes (F = 32 bf16, 8x
// fewer bytes, still took 2.59 ms), 11% of the bound.
//
// The schedule now balances slots, not rows (moderngpu's lbs_segreduce,
// Merrill and Garland's merge-based sparse product):
// - The virtual order lists every real slot row by row: row v's segment
//   in band 0, then in band 1, ... band K-1.  row_prefix[v] (int32
//   [n_rows + 1], built once per layout on the device and cached next to
//   it) counts the slots of the rows before v.
// - That order is cut into chunks of `chunk` slots, one chunk per walker,
//   so a hub row spans many walkers.  The wrapper sets chunk = 16 G (G
//   the walker's lanes, below), at least 128: enough walkers to fill the
//   card whatever F (kernel_plan in ops/kernels/spmm_banded.py sets G,
//   the chunk and the fix-up's lanes).  A
//   walker finds its first row by binary search over row_prefix and walks
//   forward; its slots in band k are one contiguous range of stream k, and
//   every slot is read once.
// - A walker finds a row's segments by scanning its bands G at a time (G
//   its lanes, below): lane i loads the bounds of band k0 + i, a vote
//   (__ballot_sync over the walker's lanes) marks the window's non-empty
//   bands, and the walker takes them in band order (__ffs), each segment's
//   bounds shuffled from the lane that loaded it.  A row's next window is
//   loaded only while the row has slots left (row_prefix counts them), so
//   an empty (row, band) pair costs no step of its own: a row of K bands
//   is at most ceil(K / G) loads issued together, not K dependent pairs
//   of loads.  The order of the slots, and so of the additions, is the
//   serial walk's.  A walker of one lane (rows of 16 bytes or less) scans
//   a band at a time and pays for the vote: at ogbn-products' size, K =
//   150, over 4-float rows 27.99 ms a launch against the serial walk's
//   25.06 (the batch sweep's call, below).
// - A walker is G lanes, each holding V columns of a message row in one
//   16-byte load: V = 4 in float32, 8 in bf16, so at F = 128 float32 one
//   warp instruction reads a whole 512-byte row, and at F = 32 (128 bytes)
//   a warp holds 4 walkers.  An F that is not a multiple of V, or a
//   stream that is not 16-byte aligned, takes the scalar form (V = 1) of
//   the same kernel, which the wrapper chooses.  Columns past 32 V go to
//   more column blocks (gridDim.y).
// - A walker keeps a batch of loads in flight (3 rows in float32, 8 in
//   bf16): it computes the batch's slot addresses (segments are
//   contiguous, so they are known ahead), starts the loads, then adds
//   them into its row's float32 accumulators, flushing at each row
//   change.  With weights (a kernel of its own, the same walker), each
//   slot's weight load is issued in the same batch, with the slot's
//   address: the walker's lanes read the same address (one load serves
//   them all), or, with heads, each lane its head's column.  The vector
//   form needs a head's columns to be whole lane vectors (F / H a
//   multiple of V); otherwise the wrapper takes the scalar form, one
//   weight an element, on the chunks and fix-up groups of the vector
//   form, so the order of additions stays that of the same messages
//   without weights.
// - A row that lies inside one chunk is written straight to out.  A row
//   that crosses a chunk edge leaves its partial sum in a float32 carry
//   buffer [n_walkers, 2, F]: side 0 for the part of a row that started
//   in an earlier chunk, side 1 for the first part of a row that goes on
//   past the chunk's end.  A second, small launch (the fix-up, a warp per
//   row) adds each such row's carries and writes it; it also writes the
//   zeros of the rows with no slot.  A hub's carries (~200 at rmat16, F =
//   32) are split into consecutive runs over the warp's spare lanes, each
//   run summed in chunk order, the runs' sums then added in order.
// - No atomics: two launches on the same inputs give the same bits, and
//   every output row is written exactly once.  The order of additions is
//   that of banded_segment_sum_scheduled_plain (ops/kernels/spmm_banded.py),
//   which reproduces the kernel's result bit for bit.
//
// Measured by chip_smoke.py at rmat16, K = 3 (NVIDIA H100 80GB HBM3, 700
// W; PERF.md): the old schedule 3.0006 ms at F = 128 float32, 11% of the
// bound; this one 0.4308 ms, 77%, and 61% in bf16.  Not built: a ring of
// shared-memory stages filled by cp.async.bulk / TMA.  The register batch
// keeps 3 x 512 bytes in flight per warp at F = 128 float32, which
// already reaches three quarters of the bound; the ring is the next step
// for bf16 and narrow rows.
//
// The indexed form (the banded SpMM's, ops/spmm.py's _apply_banded).
// The stream form's caller gathered every band first: a read of x's rows
// and a write of the [mk, F] streams, which this kernel then read back, so
// an aggregation moved its edge stream three times where the sum needs it
// once.  The indexed walker is the stream walker with one more load a
// slot: the slot's id (4 bytes, read by every lane of the walker at one
// address), then its row of x.  The id stands in front of the row, so the
// walk is staged by one batch: a batch's rows are loaded, then the next
// batch's ids and weights, then the batch's rows are added; an id has a
// batch's loads and additions to arrive in.  The ids (and weights) travel
// as K pointers in tables of 1,024 (IdPtrs, 8 KB each), with x as one
// pointer and band_rows: a layout's K grows as n_pad over the band height,
// and ogbn-products at 256 float32 columns has 150 bands.  Slots, chunks, lanes, column blocks, carries, the fix-up and
// the order of additions are the stream form's, so both forms give the
// same bits.  Its bytes are at most the stream form's, one F-wide row a
// slot, and fewer where L2 holds rows of x: at rmat16, F = 128 the 33.5
// MB table fits in the 50 MB L2 and the walk takes 0.243 ms against the
// stream form's bound of 0.333 ms; at ogbn-arxiv's size, F = 256, x is
// 173 MB and a step's sums run at 73.6% of that bound (58% as streams).
// The batch, swept on the H100 (NVIDIA H100 80GB HBM3, 700 W) with the
// walk that scans a row's bands, at the training cells' shapes, weighted,
// ms a launch for float32 batches 1 / 2 / 3 / 4 [the serial walk's kernel
// at 3, same call]: ogbn-products' size (the benchmark's graph, pull) F =
// 256, K = 150: 60.67 / 56.31 / 68.49 / 80.09 [140.52]; F = 100, K = 75:
// 23.98 / 21.50 / 28.64 / 34.26 [37.24]; ogbn-arxiv's size F = 256, K =
// 11: 0.860 / 0.765 / 1.083 / 1.289 [0.984]; F = 1,024, K = 42, [mk, 4]
// weights: 3.96 / 3.52 / 4.61 / 5.49 [7.46].  The scan's state takes
// registers: at 3 the weighted float32 kernel (64, its cap at 4 blocks an
// SM) spills 76 bytes; at 2 it spills none.  So 2 in float32.  In bf16,
// batches 2 / 4 [the serial walk at 2]: 37.10 / 34.60 [85.53], 56.37 /
// 58.96 [109.69] (F = 100: the scalar form, 200-byte rows), 0.802 / 0.742
// [0.853], 3.04 / 2.83 [5.15]; so 4 (99 registers of its 128, no spill).
// Every launch of the sweep was bitwise the serial walk's.
//
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRowTile = 128;
constexpr int kMaxBands = 128;     // the stream form's and the SDDMM's
constexpr int kMaxIdBands = 1024;  // the indexed form's
constexpr int kWarp = 32;
constexpr int kSumThreads = 256;   // threads per block of the segment sum
constexpr int kFixBatch = 8;       // carries a fix-up lane has in flight
constexpr int kRowSteps = 4;       // empty rows stepped over before a search
constexpr int kFixWarps = 8;       // warps per block of the fix-up
constexpr int kFixBlocks = 132 * 8;
constexpr int kSlotsPerWarp = 32;  // one output slot per lane
constexpr int kSddmmWarps = 8;     // warps per block of the SDDMM
constexpr int kColsPerLane = 8;    // y values a lane keeps in registers
constexpr int kColBlock = kWarp * kColsPerLane;  // columns per pass

enum { DT_FLOAT32 = 0, DT_BFLOAT16 = 1 };

// The K stream pointers travel by value in the kernel's parameters.
struct StreamPtrs {
  const void* p[kMaxBands];
};

// The indexed form's id (and weight) pointers: 8 KB a table, so the
// weighted kernel's two tables pass the classic 4 KB of parameters (the
// 32 KB that CUDA 12.1 allows on Volta and later).  At ogbn-products'
// size (2.45M rows, 123.7M slots, K = 150, weighted) a pull launch at F =
// 256 takes 56.3 ms, 69% of its bytes bound (header's sweep); its second
// column block walks every slot again.
struct IdPtrs {
  const void* p[kMaxIdBands];
};

// Flat slot index of each band's first slot; base[K] is the total.
struct StreamBases {
  long long b[kMaxBands + 1];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

// -- segment sum --------------------------------------------------------

// V consecutive elements of T as one load: 16 bytes, or one element.
template <typename T, int V> struct Vec;
template <> struct Vec<float, 4> { using raw = float4; };
template <> struct Vec<__nv_bfloat16, 8> { using raw = uint4; };
template <> struct Vec<float, 1> { using raw = float; };
template <> struct Vec<__nv_bfloat16, 1> { using raw = __nv_bfloat16; };

__device__ __forceinline__ void accumulate(float (&a)[4], const float4& r) {
  a[0] += r.x;
  a[1] += r.y;
  a[2] += r.z;
  a[3] += r.w;
}
__device__ __forceinline__ void accumulate(float (&a)[8], const uint4& r) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> float32 is exact: the high half
    a[2 * i] += __uint_as_float(w[i] << 16);
    a[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void accumulate(float (&a)[1], float r) {
  a[0] += r;
}
__device__ __forceinline__ void accumulate(float (&a)[1], __nv_bfloat16 r) {
  a[0] += __bfloat162float(r);
}

// The same with each element first scaled by the slot's weight w (already
// of the message's type): the float32 product, never contracted into an
// FMA, rounded to the message's type (nearest even; exact in float32).
__device__ __forceinline__ float weigh_bf16(float x, float w) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(x, w)));
}
__device__ __forceinline__ void accumulate(float (&a)[4], const float4& r,
                                           float w) {
  a[0] += __fmul_rn(r.x, w);
  a[1] += __fmul_rn(r.y, w);
  a[2] += __fmul_rn(r.z, w);
  a[3] += __fmul_rn(r.w, w);
}
__device__ __forceinline__ void accumulate(float (&a)[8], const uint4& r,
                                           float w) {
  const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[2 * i] += weigh_bf16(__uint_as_float(u[i] << 16), w);
    a[2 * i + 1] += weigh_bf16(__uint_as_float(u[i] & 0xffff0000u), w);
  }
}
__device__ __forceinline__ void accumulate(float (&a)[1], float r, float w) {
  a[0] += __fmul_rn(r, w);
}
__device__ __forceinline__ void accumulate(float (&a)[1], __nv_bfloat16 r,
                                           float w) {
  a[0] += weigh_bf16(__bfloat162float(r), w);
}

template <int V>
__device__ __forceinline__ void store(float* dst, const float (&a)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(a[i], a[i + 1], a[i + 2], a[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = a[i];
  }
}

struct Layout {
  const int* bounds;  // [K, n_tiles + 1]
  const int* offs2d;  // [n_tiles, K, 128]
  const int* prefix;  // [n_tiles * 128 + 1], the virtual order's row starts
  int K;
  int n_tiles;

  // [s, e): row v's segment in stream k
  __device__ __forceinline__ void segment(int v, int k, int& s,
                                          int& e) const {
    const int t = v / kRowTile, r = v % kRowTile;
    const int* off = offs2d + (static_cast<size_t>(t) * K + k) * kRowTile;
    s = off[r];
    e = r + 1 < kRowTile
            ? off[r + 1]
            : bounds[static_cast<size_t>(k) * (n_tiles + 1) + t + 1];
  }
};

// The G lanes of a walker: its lane among them, its group's first lane in
// the warp, and the group's lanes as the mask of its warp primitives.  G is
// a power of two and a block's walkers are G-aligned, so walkers that share
// a warp (G < 32) never share a mask, and each shuffles among its own lanes.
struct Lanes {
  int G, lane, base;
  unsigned mask;
};

__device__ __forceinline__ Lanes lanes_of(int G) {
  Lanes g;
  g.G = G;
  g.lane = threadIdx.x % G;
  g.base = threadIdx.x % kWarp - g.lane;
  g.mask = (G == kWarp ? 0xffffffffu : (1u << G) - 1u) << g.base;
  return g;
}

// A walker's place in the virtual order: slot j of stream k, in row v's
// segment, which ends at e; and its scan of row v's bands.  The scan holds
// a window of G bands from k0: lane i the segment [ws, we) of band k0 + i
// (empty past K), `todo` the window's non-empty bands after k (bit i for
// band k0 + i, the same in every lane), `rest` row v's slots in bands
// after k.
struct Cursor {
  int v, k, j, e;
  int k0, ws, we, rest;
  unsigned todo;
};

// The G lanes load the window of row v at c.k0 together, one band a lane,
// and vote on which of its bands hold a slot.
__device__ __forceinline__ void scan_window(const Layout& L, const Lanes& g,
                                            Cursor& c) {
  const int k = c.k0 + g.lane;
  c.ws = c.we = 0;
  if (k < L.K) L.segment(c.v, k, c.ws, c.we);
  c.todo = (__ballot_sync(g.mask, c.we > c.ws) & g.mask) >> g.base;
}

// The window's next non-empty band: its segment, from the lane that
// loaded it.
__device__ __forceinline__ void take(const Lanes& g, Cursor& c) {
  const int i = __ffs(c.todo) - 1;
  c.todo &= c.todo - 1;
  c.k = c.k0 + i;
  c.j = __shfl_sync(g.mask, c.ws, i, g.G);
  c.e = __shfl_sync(g.mask, c.we, i, g.G);
  c.rest -= c.e - c.j;
}

// To the first slot of the next non-empty segment; the caller knows that
// one remains.  An empty (row, band) pair costs no step of its own: the
// window's vote skips it, a row's later windows are loaded only while it
// has slots left, and a row with none is stepped over one by one for a
// few rows, then by binary search (the star graph's ghost row lies 100K
// empty rows past its hub).
__device__ __forceinline__ void next_segment(const Layout& L, const Lanes& g,
                                             Cursor& c, int n_rows) {
  while (c.todo == 0) {
    if (c.rest == 0 || c.k0 + g.G >= L.K) {
      ++c.v;
      const int p0 = L.prefix[c.v];
      int p1 = L.prefix[c.v + 1];
      for (int i = 0; i < kRowSteps && p1 == p0; ++i) p1 = L.prefix[++c.v + 1];
      if (p1 == p0) {
        c.v = last_le(L.prefix, n_rows, p0);
        p1 = L.prefix[c.v + 1];
      }
      c.k0 = 0;
      c.rest = p1 - p0;
    } else {
      c.k0 += g.G;
    }
    scan_window(L, g, c);
  }
  take(g, c);
}

// The slot `start` of the virtual order: its row, then its window, band
// and slot, the window's slots counted up its lanes.
__device__ __forceinline__ Cursor first_slot(const Layout& L, const Lanes& g,
                                             int start, int n_rows) {
  Cursor c;
  c.v = last_le(L.prefix, n_rows, start);
  const int p0 = L.prefix[c.v];
  int o = start - p0;
  c.rest = L.prefix[c.v + 1] - p0;
  for (c.k0 = 0;; c.k0 += g.G) {
    scan_window(L, g, c);
    const int len = c.we - c.ws;
    int upto = len;  // the window's slots in its bands up to this lane's
    for (int d = 1; d < g.G; d <<= 1) {
      const int y = __shfl_up_sync(g.mask, upto, d, g.G);
      if (g.lane >= d) upto += y;
    }
    const int in_window = __shfl_sync(g.mask, upto, g.G - 1, g.G);
    if (o < in_window) {
      const unsigned past =
          (__ballot_sync(g.mask, upto > o) & g.mask) >> g.base;
      const int i = __ffs(past) - 1;
      c.todo &= ~((2u << i) - 1u);
      c.k = c.k0 + i;
      c.j = __shfl_sync(g.mask, c.ws - (upto - len), i, g.G) + o;
      c.e = __shfl_sync(g.mask, c.we, i, g.G);
      c.rest -= __shfl_sync(g.mask, upto, i, g.G);
      return c;
    }
    o -= in_window;
    c.rest -= in_window;
  }
}

// A finished row's sums: to out when the row lies inside this chunk
// [start, stop), else to the walker's carry (side 0: the row began before
// the chunk; side 1: it goes on past it).
template <int V>
__device__ __forceinline__ void flush(const Layout& L, float* out,
                                      float* carry, int row,
                                      const float (&acc)[V], long long start,
                                      long long stop, int walker, int F,
                                      int c0) {
  const int p0 = L.prefix[row], p1 = L.prefix[row + 1];
  float* dst;
  if (p0 >= start && p1 <= stop) {
    dst = out + static_cast<size_t>(row) * F;
  } else {
    dst = carry + (static_cast<size_t>(walker) * 2 + (p0 < start ? 0 : 1)) * F;
  }
  store<V>(dst + c0, acc);
}

// Slots a walker has in flight: 3 float32 or 8 bf16 rows of 16 bytes a
// lane.  8 in bf16 was the faster of 4, 8 and 16 in a sweep on the H100 at
// rmat16 and rmat18, as 4 was in float32 (8 float32 loads take enough
// registers to halve the resident warps) until the scan of a row's bands
// took registers too: at 4 the weighted float32 kernel (64 registers)
// spills 64 bytes, at 3 none.  Swept with the scan (NVIDIA H100 80GB
// HBM3, 700 W), device ms for float32 batches 2 / 3 / 4 [the serial walk
// at 4, same call]: rmat16 K = 3, F = 128 weighted 0.418 / 0.414 / 0.648
// [0.420], unweighted 0.411 / 0.405 / 0.459 [0.411], F = 32 weighted
// 0.148 / 0.145 / 0.200 [0.149]; segment_sum (K = 1, F = 128) 0.411 /
// 0.407 / 0.458 [0.405]; ogbn-arxiv's size, weighted, K = 11, F = 256
// 1.161 / 1.120 / 1.434 [1.222], K = 42, F = 1,024, [mk, 4] 4.51 / 4.38
// / 5.64 [7.73]; every launch bitwise the serial walk's.
template <typename T>
constexpr int kBatch = sizeof(T) == 4 ? 3 : 8;

// A walker of the segment sum (the two kernels below).  kWeighted: scale
// each message by its slot's weight, wts.p[k][j * H + head], head = c0 /
// head_cols for this lane's V columns (which lie in one head); without it
// wts, H and head_cols are not read.  The weight load is issued with the
// slot's address, so no pointer is kept per slot: in float32 that holds
// the walker to 64 registers and 4 resident blocks (swept on the H100 at
// rmat16, K = 3, F = 128: 0.422 ms, against 0.484 with the weights loaded
// beside the messages and 0.412 without weights; at an ogbn-arxiv-size
// graph's F = 256 1.170 ms, 1.222, 1.113).  In bf16 it costs 4% (0.306 ms,
// 0.293, 0.259).
template <typename T, int V, bool kWeighted>
__device__ __forceinline__ void walk(const StreamPtrs& msgs,
                                     const StreamPtrs& wts, const Layout& L,
                                     float* __restrict__ out,
                                     float* __restrict__ carry, int F, int G,
                                     int chunk, int n_walkers, int H,
                                     int head_cols) {
  using Raw = typename Vec<T, V>::raw;
  const int walker = blockIdx.x * (kSumThreads / G) + threadIdx.x / G;
  const int c0 = (blockIdx.y * G + threadIdx.x % G) * V;  // first column
  const int n_rows = L.n_tiles * kRowTile;
  const int total = L.prefix[n_rows];
  const long long start = static_cast<long long>(walker) * chunk;
  if (walker >= n_walkers || start >= total) return;
  const long long stop = start + chunk;
  const int end = static_cast<int>(stop < total ? stop : total);
  const bool lane_on = c0 < F;
  const int head = kWeighted && lane_on ? c0 / head_cols : 0;

  const Lanes g = lanes_of(G);
  Cursor c = first_slot(L, g, static_cast<int>(start), n_rows);

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.0f;
  int row = c.v;
  constexpr int B = kBatch<T>;
  for (int base = static_cast<int>(start); base < end; base += B) {
    const int n = min(B, end - base);
    const Raw* src[B];
    T wv[B];
    int rows[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      if (u < n) {
        if (c.j == c.e) next_segment(L, g, c, n_rows);
        src[u] = reinterpret_cast<const Raw*>(
            static_cast<const T*>(msgs.p[c.k]) +
            static_cast<size_t>(c.j) * F + c0);
        if constexpr (kWeighted)
          if (lane_on)
            wv[u] = __ldg(static_cast<const T*>(wts.p[c.k]) +
                          static_cast<size_t>(c.j) * H + head);
        rows[u] = c.v;
        ++c.j;
      }
    }
    Raw val[B];
#pragma unroll
    for (int u = 0; u < B; ++u)
      if (u < n && lane_on) val[u] = __ldg(src[u]);
#pragma unroll
    for (int u = 0; u < B; ++u) {
      if (u < n) {
        if (rows[u] != row) {
          if (lane_on)
            flush<V>(L, out, carry, row, acc, start, stop, walker, F, c0);
          row = rows[u];
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = 0.0f;
        }
        if (lane_on) {
          if constexpr (kWeighted) accumulate(acc, val[u], to_f32(wv[u]));
          else accumulate(acc, val[u]);
        }
      }
    }
  }
  if (lane_on) flush<V>(L, out, carry, row, acc, start, stop, walker, F, c0);
}

template <typename T, int V>
__global__ void __launch_bounds__(kSumThreads)
banded_segment_sum_kernel(const __grid_constant__ StreamPtrs msgs,
                          const Layout L, float* __restrict__ out,
                          float* __restrict__ carry, int F, int G, int chunk,
                          int n_walkers) {
  walk<T, V, false>(msgs, msgs, L, out, carry, F, G, chunk, n_walkers, 1, F);
}

// The weighted walkers, held to 4 resident blocks in float32 (64
// registers) and 2 in bf16 (128).
template <typename T, int V>
__global__ void __launch_bounds__(kSumThreads, sizeof(T) == 4 ? 4 : 2)
banded_segment_sum_kernel(const __grid_constant__ StreamPtrs msgs,
                          const __grid_constant__ StreamPtrs wts,
                          const Layout L, float* __restrict__ out,
                          float* __restrict__ carry, int F, int G, int chunk,
                          int n_walkers, int H, int head_cols) {
  walk<T, V, true>(msgs, wts, L, out, carry, F, G, chunk, n_walkers, H,
                   head_cols);
}

// Slots an indexed walker has in flight: a batch's rows of x, while the
// next batch's ids (and weights) load.  Swept on the H100 (header).
template <typename T>
constexpr int kIndexedBatch = sizeof(T) == 4 ? 2 : 4;

// A walker of the indexed form (the two kernels below): the walk of
// `walk`, the same slots in the same order and the same additions, with
// slot j of band k read from row band_lo(k) + ids.p[k][j] of the table x
// (band_lo(k) = k band_rows) in place of row j of a gathered stream.  The
// loop is staged by one batch: the current batch's rows of x are loaded,
// then the next batch's ids and weights, then the current rows are added,
// so an id's load is never waited on by the rows it names.
template <typename T, int V, bool kWeighted>
__device__ __forceinline__ void walk_indexed(
    const T* __restrict__ x, int band_rows, const IdPtrs& ids,
    const IdPtrs& wts, const Layout& L, float* __restrict__ out,
    float* __restrict__ carry, int F, int G, int chunk, int n_walkers,
    int H, int head_cols) {
  using Raw = typename Vec<T, V>::raw;
  const int walker = blockIdx.x * (kSumThreads / G) + threadIdx.x / G;
  const int c0 = (blockIdx.y * G + threadIdx.x % G) * V;  // first column
  const int n_rows = L.n_tiles * kRowTile;
  const int total = L.prefix[n_rows];
  const long long start = static_cast<long long>(walker) * chunk;
  if (walker >= n_walkers || start >= total) return;
  const long long stop = start + chunk;
  const int end = static_cast<int>(stop < total ? stop : total);
  const bool lane_on = c0 < F;
  const int head = kWeighted && lane_on ? c0 / head_cols : 0;
  const Lanes g = lanes_of(G);
  Cursor c = first_slot(L, g, static_cast<int>(start), n_rows);

  // the staged batch: each slot's row of x (its band's first row and its
  // id), its weight and its output row
  constexpr int B = kIndexedBatch<T>;
  int lo[B], id[B], rows[B];
  T wv[B];
  int n = min(B, end - static_cast<int>(start));
#pragma unroll
  for (int u = 0; u < B; ++u) {
    if (u < n) {
      if (c.j == c.e) next_segment(L, g, c, n_rows);
      lo[u] = c.k * band_rows;
      id[u] = __ldg(static_cast<const int*>(ids.p[c.k]) + c.j);
      if constexpr (kWeighted)
        if (lane_on)
          wv[u] = __ldg(static_cast<const T*>(wts.p[c.k]) +
                        static_cast<size_t>(c.j) * H + head);
      rows[u] = c.v;
      ++c.j;
    }
  }

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.0f;
  int row = rows[0];
  for (int base = static_cast<int>(start); base < end; base += B) {
    const int m = n;
    Raw val[B];
#pragma unroll
    for (int u = 0; u < B; ++u)
      if (u < m && lane_on)
        val[u] = __ldg(reinterpret_cast<const Raw*>(
            x + static_cast<size_t>(lo[u] + id[u]) * F + c0));
    int now_rows[B];
    T now_w[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      now_rows[u] = rows[u];
      if constexpr (kWeighted) now_w[u] = wv[u];
    }
    // stage the next batch while these rows are in flight
    n = min(B, end - (base + B));
#pragma unroll
    for (int u = 0; u < B; ++u) {
      if (u < n) {
        if (c.j == c.e) next_segment(L, g, c, n_rows);
        lo[u] = c.k * band_rows;
        id[u] = __ldg(static_cast<const int*>(ids.p[c.k]) + c.j);
        if constexpr (kWeighted)
          if (lane_on)
            wv[u] = __ldg(static_cast<const T*>(wts.p[c.k]) +
                          static_cast<size_t>(c.j) * H + head);
        rows[u] = c.v;
        ++c.j;
      }
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      if (u < m) {
        if (now_rows[u] != row) {
          if (lane_on)
            flush<V>(L, out, carry, row, acc, start, stop, walker, F, c0);
          row = now_rows[u];
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = 0.0f;
        }
        if (lane_on) {
          if constexpr (kWeighted) accumulate(acc, val[u], to_f32(now_w[u]));
          else accumulate(acc, val[u]);
        }
      }
    }
  }
  if (lane_on) flush<V>(L, out, carry, row, acc, start, stop, walker, F, c0);
}

// The indexed form of the two kernels above: the same name, so a trace
// counts its time as kernel 2's.
template <typename T, int V>
__global__ void __launch_bounds__(kSumThreads)
banded_segment_sum_kernel(const T* __restrict__ x, int band_rows,
                          const __grid_constant__ IdPtrs ids,
                          const Layout L, float* __restrict__ out,
                          float* __restrict__ carry, int F, int G, int chunk,
                          int n_walkers) {
  walk_indexed<T, V, false>(x, band_rows, ids, ids, L, out, carry, F, G,
                            chunk, n_walkers, 1, F);
}

template <typename T, int V>
__global__ void __launch_bounds__(kSumThreads, sizeof(T) == 4 ? 4 : 2)
banded_segment_sum_kernel(const T* __restrict__ x, int band_rows,
                          const __grid_constant__ IdPtrs ids,
                          const __grid_constant__ IdPtrs wts,
                          const Layout L, float* __restrict__ out,
                          float* __restrict__ carry, int F, int G, int chunk,
                          int n_walkers, int H, int head_cols) {
  walk_indexed<T, V, true>(x, band_rows, ids, wts, L, out, carry, F, G,
                           chunk, n_walkers, H, head_cols);
}

// The rows the walkers did not write: a row with no slot gets zeros; a row
// that crosses chunk edges gets its carries added in chunk order.  A warp
// per row: `lanes` lanes (a power of two) cover F, V columns each, and the
// warp's 32 / lanes groups of them split a row's later carries into
// consecutive runs (the rmat16 hub has ~200 at F = 32).  Each group adds
// its run in order, kFixBatch loads in flight; then, in group order, the
// runs' sums are added to side 1 of the row's first chunk.
template <int V>
__global__ void __launch_bounds__(kWarp * kFixWarps)
banded_fixup_kernel(const int* __restrict__ prefix,
                    const float* __restrict__ carry, float* __restrict__ out,
                    int n_rows, int F, int chunk, int lanes) {
  const int lane = threadIdx.x % kWarp;
  const int groups = kWarp / lanes, group = lane / lanes;
  const int c_lane = (lane % lanes) * V;
  for (int v = blockIdx.x * kFixWarps + threadIdx.x / kWarp; v < n_rows;
       v += gridDim.x * kFixWarps) {  // v is the same for the whole warp
    const int p0 = prefix[v], p1 = prefix[v + 1];
    float* o = out + static_cast<size_t>(v) * F;
    if (p0 == p1) {
      const float zero[V] = {};
      for (int c = lane * V; c < F; c += kWarp * V) store<V>(o + c, zero);
      continue;
    }
    const int b0 = p0 / chunk, b1 = (p1 - 1) / chunk;
    if (b0 == b1) continue;  // the walker of chunk b0 wrote it
    const int per = (b1 - b0 + groups - 1) / groups;
    const int lo = b0 + 1 + group * per;
    const int hi = min(lo + per, b1 + 1);
    for (int c0 = 0; c0 < F; c0 += lanes * V) {  // the same trip count
      const int c = c0 + c_lane;                 // for every lane
      const bool on = c < F;
      float part[V];
#pragma unroll
      for (int i = 0; i < V; ++i) part[i] = 0.0f;
      for (int b = lo; on && b < hi; b += kFixBatch) {
        float t[kFixBatch][V];
#pragma unroll
        for (int u = 0; u < kFixBatch; ++u)
          if (b + u < hi) {
            const float* cb = carry + static_cast<size_t>(b + u) * 2 * F + c;
#pragma unroll
            for (int i = 0; i < V; ++i) t[u][i] = cb[i];
          }
#pragma unroll
        for (int u = 0; u < kFixBatch; ++u)
          if (b + u < hi) {
#pragma unroll
            for (int i = 0; i < V; ++i) part[i] += t[u][i];
          }
      }
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i)
        acc[i] = on ? carry[(static_cast<size_t>(b0) * 2 + 1) * F + c + i]
                    : 0.0f;
      for (int g = 0; g < groups; ++g) {
#pragma unroll
        for (int i = 0; i < V; ++i)
          acc[i] += __shfl_sync(0xffffffffu, part[i],
                                g * lanes + lane % lanes);
      }
      if (on && group == 0) store<V>(o + c, acc);
    }
  }
}

// ptrs: the K message streams (P = StreamPtrs), or with a table x the K
// id streams (P = IdPtrs).  wts: the streams' weights, or null pointers
// for none.
template <typename T, int V, typename P>
void launch_sum(const P& ptrs, const P& wts, int H,
                const T* x, int band_rows, const Layout& L, float* out,
                float* carry, int F, int G, int chunk, int n_walkers,
                int fix_lanes, cudaStream_t s) {
  const int per_block = kSumThreads / G;
  if (n_walkers > 0) {
    const dim3 grid((n_walkers + per_block - 1) / per_block,
                    (F + G * V - 1) / (G * V));
    const bool weighted = wts.p[0] != nullptr;
    if constexpr (std::is_same_v<P, IdPtrs>) {
      if (weighted)
        banded_segment_sum_kernel<T, V><<<grid, kSumThreads, 0, s>>>(
            x, band_rows, ptrs, wts, L, out, carry, F, G, chunk, n_walkers,
            H, F / H);
      else
        banded_segment_sum_kernel<T, V><<<grid, kSumThreads, 0, s>>>(
            x, band_rows, ptrs, L, out, carry, F, G, chunk, n_walkers);
    } else if (weighted)
      banded_segment_sum_kernel<T, V><<<grid, kSumThreads, 0, s>>>(
          ptrs, wts, L, out, carry, F, G, chunk, n_walkers, H, F / H);
    else
      banded_segment_sum_kernel<T, V><<<grid, kSumThreads, 0, s>>>(
          ptrs, L, out, carry, F, G, chunk, n_walkers);
  }
  const int n_rows = L.n_tiles * kRowTile;
  const int rows_blocks = (n_rows + kFixWarps - 1) / kFixWarps;
  const int blocks = rows_blocks < kFixBlocks ? rows_blocks : kFixBlocks;
  constexpr int VF = V % 4 == 0 ? 4 : 1;  // float32 carries
  banded_fixup_kernel<VF><<<blocks, kWarp * kFixWarps, 0, s>>>(
      L.prefix, carry, out, n_rows, F, chunk, fix_lanes);
}

// -- SDDMM --------------------------------------------------------------

// Banded SDDMM, the second entry point below:
//   dw[base_k + j, h] = <y[dst(k, j), h d:(h + 1) d], msgs[k][j, h d:(h + 1) d]>
// with d = F / H, for every slot j < bounds[k, n_tiles] of band k, where
// dst(k, j) is the row whose staircase segment holds j; slots past the
// band's end are exactly 0.  H = 1 is the SpMM's weight cotangent, H > 1
// GAT's per-head one.  It replaces mini_tpu/ops/pallas/spmm_banded.py,
// banded_sddmm.  The TPU kernel walks 128-row output tiles and multiplies
// each 512-edge chunk against the tile on the MXU, with a "pure chunk"
// path and a read-modify-write of chunks that straddle two tiles, all of
// it because its grid runs in order on one core; it pads each head to 128
// lanes and runs H passes.  Here the output is per slot, so the kernel is
// edge-parallel: one warp owns 32 consecutive slots of one band, and a hub
// row spreads over as many warps as it has runs of 32 slots.
//
// What bounds it on an H100: bytes.  Each message row is read once (y rows
// come from cache: a segment's slots are neighbours), 2 operations per 4
// bytes of float32 message.  At rmat16, K = 3, F = 128 float32: 1.074 GB of
// messages, 33.6 MB of y, 8.4 MB out: 0.333 ms at 3.35 TB/s.
//
// The first form of this kernel read one scalar a lane per load (columns
// lane, lane + 32, ...: a warp instruction moved 128 of a row's 512 bytes,
// 64 in bf16), stepped the staircase in memory inside its slot loop, and
// with H heads did all of it H times: 58% of the bound in float32, 32%
// with bf16 messages, 49% with 2 heads (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md).  The design now:
// - The destination row of a slot is read, not searched: seg[k][j], the
//   per-slot row ids the layout keeps on the device (4 bytes a slot, under
//   1% of the bytes at F = 128).  Lane s loads the id of the warp's slot s
//   in one coalesced instruction; a shuffle hands it to the lanes that
//   work on that slot.
// - 16-byte loads.  A lane holds V consecutive columns of a message row (V
//   = 4 float32, 8 bf16).  The G lanes that cover a row (G = the power of
//   two >= F / V, at most 32) form a slot's lane group, and a warp works
//   on 32 / G neighbouring slots per instruction: one 512-byte row in
//   float32 at F = 128, two rows in bf16, four at F = 32 float32.
// - All heads in one pass.  The F / (H V) lanes that hold head h's columns
//   are an aligned sub-group of the lane group; the shuffle sum runs
//   inside it (H = 2, F = 128 float32: two groups of 16, 4 steps), so the
//   slots are walked once and every head's dot comes from one read of the
//   row.
// - The y row of a slot is loaded with its message row, both at once:
//   neighbouring slots share a row, so the load hits L1, and no lane waits
//   on a row change.  The message loads are streaming loads (read once),
//   so they do not push y out of the caches.
// - One row a lane group in flight, and the card's resident warps hide
//   the latency.  A batch of B rows in flight per lane with a transposed
//   shuffle fold (B - 1 shuffles for B dots) was built and swept on the
//   H100 at rmat16, K = 3, F = 128: float32 0.3801, 0.3890, 0.3822, 0.3854
//   ms for B = 1, 2, 4, 8; bf16 messages 0.2080, 0.2360, 0.3249, 0.5438 ms
//   (the batch's registers cost more resident warps than its loads gain).
//   So B = 1 stayed and the batch went.
// - Products and sums are single float32 operations in a fixed order
//   (__fmul_rn, __fadd_rn: no fused multiply-add), the same as
//   banded_sddmm_scheduled_plain (ops/kernels/spmm_banded.py), which
//   reproduces the kernel bit for bit.  No atomics; every slot is written
//   exactly once.
// Measured at rmat16, K = 3, F = 128 on the device (NVIDIA H100 80GB
// HBM3, 700 W; chip_smoke.py, two runs): float32 0.374-0.388 ms (86-90%
// of the bound), bf16 messages 0.211-0.219 (80-83%), 2 heads 0.386-0.396
// (85-88%), 4 heads 0.393-0.409; F = 32 0.094-0.097 (91-93%); rmat18, K =
// 9, F = 32 0.402-0.415 (85-87%); the scalar form at F = 33 0.275-0.278
// (32-33%).
// An F that is no multiple of V, more than 32 V columns, a head width
// whose lanes are no power of two, or an unaligned pointer takes the
// scalar form: one column a lane and load, columns lane, lane + 32, ...,
// the 32 slots one after another and once per head, with the same per-slot
// row ids.  The wrapper chooses (sddmm_plan).

// V columns of one row as floats, one load of up to 16 bytes (two for 8
// float32).  kStream: a streaming load, for bytes read once (the messages),
// so that they do not push the y rows out of the caches.
template <bool kStream, typename R>
__device__ __forceinline__ R load_raw(const R* p) {
  return kStream ? __ldcs(p) : __ldg(p);
}
template <typename T, int V> struct Cols;
template <> struct Cols<float, 4> {
  template <bool kStream>
  static __device__ __forceinline__ void load(const float* p, float (&f)[4]) {
    const float4 r = load_raw<kStream>(reinterpret_cast<const float4*>(p));
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
};
template <> struct Cols<float, 8> {
  template <bool kStream>
  static __device__ __forceinline__ void load(const float* p, float (&f)[8]) {
    const float4 a = load_raw<kStream>(reinterpret_cast<const float4*>(p));
    const float4 b = load_raw<kStream>(reinterpret_cast<const float4*>(p) + 1);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};
__device__ __forceinline__ void unpack_bf16(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);  // bf16 -> float32 is exact: the high half
  hi = __uint_as_float(w & 0xffff0000u);
}
template <> struct Cols<__nv_bfloat16, 4> {
  template <bool kStream>
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&f)[4]) {
    const uint2 r = load_raw<kStream>(reinterpret_cast<const uint2*>(p));
    unpack_bf16(r.x, f[0], f[1]);
    unpack_bf16(r.y, f[2], f[3]);
  }
};
template <> struct Cols<__nv_bfloat16, 8> {
  template <bool kStream>
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&f)[8]) {
    const uint4 r = load_raw<kStream>(reinterpret_cast<const uint4*>(p));
    unpack_bf16(r.x, f[0], f[1]);
    unpack_bf16(r.y, f[2], f[3]);
    unpack_bf16(r.z, f[4], f[5]);
    unpack_bf16(r.w, f[6], f[7]);
  }
};

// What the two forms share: the warp's run of 32 slots, its band, and the
// band's real length.
struct SddmmRun {
  long long s0;  // flat slot of lane 0
  int k, j0, end;
};

__device__ __forceinline__ SddmmRun sddmm_run(const StreamBases& base,
                                              const int* bounds, int K,
                                              int n_tiles, long long run) {
  SddmmRun r;
  r.s0 = run * kSlotsPerWarp;
  r.k = 0;
  while (r.k + 1 < K && base.b[r.k + 1] <= r.s0) ++r.k;
  r.j0 = static_cast<int>(r.s0 - base.b[r.k]);
  // the band's real slots are [0, end)
  r.end = bounds[static_cast<size_t>(r.k) * (n_tiles + 1) + n_tiles];
  return r;
}

// G: a slot's lanes; Lh: a head's lanes, dividing G (G for one head); both
// powers of two.  F = V times the lanes that hold columns (<= G).
template <typename TM, typename TY>
__global__ void __launch_bounds__(kWarp * kSddmmWarps)
banded_sddmm_kernel(const __grid_constant__ StreamPtrs msgs,
                    const __grid_constant__ StreamPtrs segs,
                    const __grid_constant__ StreamBases base,
                    const int* __restrict__ bounds,
                    const TY* __restrict__ y, float* __restrict__ out, int K,
                    int n_tiles, int F, int H, int G, int Lh,
                    long long n_runs) {
  constexpr int V = 16 / sizeof(TM);
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x % kWarp;
  const long long run =
      static_cast<long long>(blockIdx.x) * kSddmmWarps + threadIdx.x / kWarp;
  if (run >= n_runs) return;
  const SddmmRun r = sddmm_run(base, bounds, K, n_tiles, run);
  const TM* m = static_cast<const TM*>(msgs.p[r.k]);
  // lane s: the row of the warp's slot s (a pad slot's id is a valid row)
  const int my_row = static_cast<const int*>(segs.p[r.k])[r.j0 + lane];
  const int S = kWarp / G;             // slots per step
  const int sg = lane / G;             // this lane's slot within a step
  const int c = (lane % G) * V;        // its first column
  const int head = (lane % G) / Lh;    // >= H: lanes past the last head
  const bool col_on = c < F;
  for (int step = 0; step < G; ++step) {
    const int slot = step * S + sg;
    const int row = __shfl_sync(kFull, my_row, slot);
    const int j = r.j0 + slot;
    float p = 0.0f;
    if (col_on && j < r.end) {
      float mv[V], yv[V];
      Cols<TM, V>::template load<true>(m + static_cast<size_t>(j) * F + c,
                                       mv);
      Cols<TY, V>::template load<false>(y + static_cast<size_t>(row) * F + c,
                                        yv);
      p = __fmul_rn(yv[0], mv[0]);
#pragma unroll
      for (int i = 1; i < V; ++i)
        p = __fadd_rn(p, __fmul_rn(yv[i], mv[i]));
    }
    for (int o = Lh / 2; o >= 1; o /= 2)
      p = __fadd_rn(p, __shfl_xor_sync(kFull, p, o));
    if (head < H && lane % Lh == 0)
      out[(r.s0 + slot) * H + head] = p;
  }
}

// The scalar form: any F and H, one column a lane and load.  Lane s
// accumulates slot j0 + s; a pad slot adds nothing and stays 0.
template <typename TM, typename TY>
__global__ void __launch_bounds__(kWarp * kSddmmWarps)
banded_sddmm_scalar_kernel(const __grid_constant__ StreamPtrs msgs,
                           const __grid_constant__ StreamPtrs segs,
                           const __grid_constant__ StreamBases base,
                           const int* __restrict__ bounds,
                           const TY* __restrict__ y, float* __restrict__ out,
                           int K, int n_tiles, int F, int H,
                           long long n_runs) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x % kWarp;
  const long long run =
      static_cast<long long>(blockIdx.x) * kSddmmWarps + threadIdx.x / kWarp;
  if (run >= n_runs) return;
  const SddmmRun r = sddmm_run(base, bounds, K, n_tiles, run);
  const TM* m = static_cast<const TM*>(msgs.p[r.k]);
  const int my_row = static_cast<const int*>(segs.p[r.k])[r.j0 + lane];
  const int j1 = min(r.j0 + kSlotsPerWarp, r.end);
  const int d = F / H;  // head h dots columns [h d, (h + 1) d)
  for (int h = 0; h < H; ++h) {
    const int c_end = (h + 1) * d;
    float acc = 0.0f;
    for (int c0 = h * d; c0 < c_end; c0 += kColBlock) {
      int row = -1;
      float yv[kColsPerLane];
      for (int j = r.j0; j < j1; ++j) {
        const int v = __shfl_sync(kFull, my_row, j - r.j0);
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
          if (c < c_end) p = __fadd_rn(p, __fmul_rn(yv[i], to_f32(mj[c])));
        }
#pragma unroll
        for (int o = kWarp / 2; o > 0; o /= 2)
          p = __fadd_rn(p, __shfl_xor_sync(kFull, p, o));
        if (lane == j - r.j0) acc = __fadd_rn(acc, p);
      }
    }
    out[(r.s0 + lane) * H + h] = acc;
  }
}

struct SddmmArgs {
  StreamPtrs msgs, segs;
  StreamBases base;
  const int* bounds;
  const void* y;
  float* out;
  int K, n_tiles, F, H, G, Lh;
  long long n_runs;
  cudaStream_t stream;
};

template <typename TM, typename TY>
void launch_sddmm(const SddmmArgs& a, bool vector) {
  const long long blocks = (a.n_runs + kSddmmWarps - 1) / kSddmmWarps;
  const dim3 grid(static_cast<unsigned>(blocks));
  const TY* y = static_cast<const TY*>(a.y);
  if (vector) {
    banded_sddmm_kernel<TM, TY><<<grid, kWarp * kSddmmWarps, 0, a.stream>>>(
        a.msgs, a.segs, a.base, a.bounds, y, a.out, a.K, a.n_tiles, a.F, a.H,
        a.G, a.Lh, a.n_runs);
  } else {
    banded_sddmm_scalar_kernel<TM, TY>
        <<<grid, kWarp * kSddmmWarps, 0, a.stream>>>(
            a.msgs, a.segs, a.base, a.bounds, y, a.out, a.K, a.n_tiles, a.F,
            a.H, a.n_runs);
  }
}

// The segment sum's launch with the K pointers (and weights) in tables of
// type P (the form's), dispatched by dtype; the entry below has checked
// them.
template <typename P>
int sum_with(const void* const* msg_ptrs, int K, const Layout& L,
             float* out, float* carry, int F, int dtype, int vector, int G,
             int chunk, int n_walkers, int fix_lanes,
             const void* const* wt_ptrs, int H, const void* table,
             int band_rows, cudaStream_t s) {
  P ptrs = {}, wts = {};
  for (int k = 0; k < K; ++k) {
    ptrs.p[k] = msg_ptrs[k];
    if (wt_ptrs != nullptr) {
      if (wt_ptrs[k] == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      wts.p[k] = wt_ptrs[k];
    }
  }
  const int C = chunk, W = n_walkers, FL = fix_lanes, R = band_rows;
  if (dtype == DT_FLOAT32) {
    const float* x = static_cast<const float*>(table);
    if (vector)
      launch_sum<float, 4>(ptrs, wts, H, x, R, L, out, carry, F, G, C, W, FL,
                           s);
    else
      launch_sum<float, 1>(ptrs, wts, H, x, R, L, out, carry, F, G, C, W, FL,
                           s);
  } else if (dtype == DT_BFLOAT16) {
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(table);
    if (vector)
      launch_sum<__nv_bfloat16, 8>(ptrs, wts, H, x, R, L, out, carry, F, G,
                                   C, W, FL, s);
    else
      launch_sum<__nv_bfloat16, 1>(ptrs, wts, H, x, R, L, out, carry, F, G,
                                   C, W, FL, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most bands a launch takes: kMaxBands for the stream form and the
// SDDMM, kMaxIdBands for the indexed segment sum.
extern "C" int banded_max_bands() { return kMaxBands; }
extern "C" int banded_max_indexed_bands() { return kMaxIdBands; }

// msg_ptrs: host array of K device pointers: the message streams, or,
// with a table, the streams' ids (int32 [mk_pad], band-local).  table:
// null for the stream form; else the source rows x ([n_src, F] of
// `dtype`), slot j of band k reading row k * band_rows + msg_ptrs[k][j].
// K: at most kMaxBands for streams, kMaxIdBands with a table.
// prefix: int32 [n_tiles * 128 + 1], the row starts of the virtual order
// (row_prefix).  carry: float32 [n_walkers, 2, F] scratch, n_walkers >=
// ceil(prefix[-1] / chunk).  vector: nonzero when F * element size is a
// multiple of 16 and every stream (or the table) is 16-byte aligned.
// lanes, fix_lanes: a walker's lanes and the fix-up's lanes per row,
// powers of two up to 32 (the wrapper's kernel_plan).  wt_ptrs: null for
// no weights, else a host array of K device pointers to the streams'
// weights, [mk_pad] (heads 1) or [mk_pad, heads] of the messages' type;
// heads divides F and, on the vector path, F / heads is a multiple of the
// lane's 16 bytes of columns.  Two launches: the walkers, then the
// fix-up.  Returns cudaGetLastError() after them (0 on success), or
// cudaErrorInvalidValue for bad arguments.
extern "C" int banded_segment_sum_launch(
    const void* const* msg_ptrs, int K, const void* bounds,
    const void* offs2d, const void* prefix, void* out, void* carry,
    int n_tiles, int F, int dtype, int vector, int lanes, int chunk,
    int n_walkers, int fix_lanes, const void* const* wt_ptrs, int heads,
    const void* table, int band_rows, void* stream) {
  const auto lanes_ok = [](int x) {
    return x >= 1 && x <= kWarp && (x & (x - 1)) == 0;
  };
  const int V = vector ? (dtype == DT_FLOAT32 ? 4 : 8) : 1;
  const int max_bands = table != nullptr ? kMaxIdBands : kMaxBands;
  if (K < 1 || K > max_bands || n_tiles < 0 || F < 1 || chunk < 1 ||
      n_walkers < 0 || !lanes_ok(lanes) || !lanes_ok(fix_lanes) ||
      heads < 1 || F % heads || (F / heads) % V ||
      (table != nullptr && band_rows < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  const Layout L = {static_cast<const int*>(bounds),
                    static_cast<const int*>(offs2d),
                    static_cast<const int*>(prefix), K, n_tiles};
  const auto sum = table != nullptr ? sum_with<IdPtrs>
                                    : sum_with<StreamPtrs>;
  return sum(msg_ptrs, K, L, static_cast<float*>(out),
             static_cast<float*>(carry), F, dtype, vector, lanes, chunk,
             n_walkers, fix_lanes, wt_ptrs, heads, table, band_rows,
             static_cast<cudaStream_t>(stream));
}

// msg_ptrs, seg_ptrs, lens: host arrays of K device pointers to the
// streams, K to their per-slot row ids (int32 [lens[k]]) and K stream
// lengths (each a multiple of 32).  H: heads, dividing F.  out: float32
// [sum(lens), H].  msg_dtype, y_dtype: DT_FLOAT32 or DT_BFLOAT16.  lanes,
// head_lanes: the wrapper's sddmm_plan: lanes 0 is the scalar form; else
// the vector form's lanes a slot (a power of two up to 32 that covers F in
// 16-byte vectors) and lanes a head (a power of two dividing lanes), for
// rows of whole 16-byte vectors and 16-byte aligned pointers.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for bad arguments.
extern "C" int banded_sddmm_launch(const void* const* msg_ptrs,
                                   const void* const* seg_ptrs,
                                   const long long* lens, int K,
                                   const void* bounds, const void* y,
                                   void* out, int n_tiles, int F, int H,
                                   int msg_dtype, int y_dtype, int lanes,
                                   int head_lanes, void* stream) {
  const auto dtype_ok = [](int d) {
    return d == DT_FLOAT32 || d == DT_BFLOAT16;
  };
  const auto pow2 = [](int x) { return x >= 1 && (x & (x - 1)) == 0; };
  if (K < 1 || K > kMaxBands || n_tiles < 1 || F < 1 || H < 1 || F % H ||
      !dtype_ok(msg_dtype) || !dtype_ok(y_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes != 0) {
    const int V = msg_dtype == DT_FLOAT32 ? 4 : 8;
    if (!pow2(lanes) || lanes > kWarp || !pow2(head_lanes) ||
        lanes % head_lanes || F % V || F > lanes * V ||
        (H > 1 ? head_lanes * V * H != F : head_lanes != lanes))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  SddmmArgs a = {};
  for (int k = 0; k < K; ++k) {
    if (lens[k] < 0 || lens[k] % kSlotsPerWarp)
      return static_cast<int>(cudaErrorInvalidValue);
    a.msgs.p[k] = msg_ptrs[k];
    a.segs.p[k] = seg_ptrs[k];
    a.base.b[k + 1] = a.base.b[k] + lens[k];
  }
  a.n_runs = a.base.b[K] / kSlotsPerWarp;
  if (a.n_runs == 0) return 0;
  a.bounds = static_cast<const int*>(bounds);
  a.y = y;
  a.out = static_cast<float*>(out);
  a.K = K;
  a.n_tiles = n_tiles;
  a.F = F;
  a.H = H;
  a.G = lanes;
  a.Lh = head_lanes;
  a.stream = static_cast<cudaStream_t>(stream);
  const bool vector = lanes != 0;
  const int code = msg_dtype * 2 + y_dtype;
  if (code == DT_FLOAT32 * 2 + DT_FLOAT32) {
    launch_sddmm<float, float>(a, vector);
  } else if (code == DT_FLOAT32 * 2 + DT_BFLOAT16) {
    launch_sddmm<float, __nv_bfloat16>(a, vector);
  } else if (code == DT_BFLOAT16 * 2 + DT_FLOAT32) {
    launch_sddmm<__nv_bfloat16, float>(a, vector);
  } else {
    launch_sddmm<__nv_bfloat16, __nv_bfloat16>(a, vector);
  }
  return static_cast<int>(cudaGetLastError());
}
