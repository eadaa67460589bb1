// Native graph loader + CSR/CSC builder of mini_tpu_torch (the same C++
// as mini_tpu's native/src/loader.cpp; the port keeps its own copy).
//
// Role parity with gunrock/mini's host-side loader (src/graph.hxx:96-223):
// parse MatrixMarket-ish files (% comments, "rows cols nnz" header, 1-based
// indices, optional undirected doubling), stable-sort edges, build CSR and
// CSC with a per-edge source array.  Differences on purpose (SURVEY.md §7):
// column 1 is the source (transpose flag reproduces the reference's
// column-2 convention) and the CSC is a real transpose for directed graphs.
//
// Exposed as a C ABI for ctypes.  Semantics bitwise-match the NumPy path
// of mini_tpu_torch.graph.csr.from_edges (stable (src,dst) / (dst,src)
// sorts; duplicate edges kept).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <map>
#include <mutex>
#include <numeric>
#include <vector>

namespace {

struct Graph {
  int64_t n = 0, m = 0;
  std::vector<int64_t> row_offsets, col_offsets;
  std::vector<int32_t> csr_srcs, csr_dsts, csc_srcs, csc_dsts, csc_eids;
  std::vector<float> csr_weights, csc_weights;
};

std::mutex g_mutex;
std::map<int, Graph*> g_registry;
int g_next_handle = 1;

// Fast int parse (no locale, no errno churn).
inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* parse_i64(const char* p, const char* end, int64_t* out) {
  p = skip_ws(p, end);
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  *out = neg ? -v : v;
  return p;
}

inline const char* parse_f32(const char* p, const char* end, float* out,
                             bool* found) {
  p = skip_ws(p, end);
  if (p >= end || *p == '\n') {
    *found = false;
    return p;
  }
  char* q = nullptr;
  *out = strtof(p, &q);
  *found = (q != p);
  return q ? q : p;
}

// Stable LSD radix sort of (key, value) pairs, 16-bit digits, only as
// many passes as the highest set key bit needs.  Stability gives the
// same tie order as np.lexsort / std::stable_sort; packed u64 keys make
// each pass a sequential scan (the old comparator-based stable_sort did
// two random array reads per comparison — 3-4x slower at graph sizes).
void radix_sort_pairs(std::vector<uint64_t>& keys,
                      std::vector<int64_t>& vals) {
  const size_t m = keys.size();
  uint64_t mx = 0;
  for (uint64_t k : keys) mx |= k;
  int passes = 0;
  while (passes < 4 && (mx >> (16 * passes)) != 0) ++passes;
  // (shifting a u64 by >= 64 is UB — the passes < 4 bound keeps every
  // shift in range; 4 passes always suffice for a 64-bit key)
  std::vector<uint64_t> kbuf(m);
  std::vector<int64_t> vbuf(m);
  std::vector<int64_t> cnt(1 << 16);
  for (int p = 0; p < passes; ++p) {
    const int sh = 16 * p;
    std::fill(cnt.begin(), cnt.end(), 0);
    for (uint64_t k : keys) cnt[(k >> sh) & 0xFFFF]++;
    int64_t sum = 0;
    for (int i = 0; i < (1 << 16); ++i) {
      const int64_t c = cnt[i];
      cnt[i] = sum;
      sum += c;
    }
    for (size_t i = 0; i < m; ++i) {
      const int64_t pos = cnt[(keys[i] >> sh) & 0xFFFF]++;
      kbuf[pos] = keys[i];
      vbuf[pos] = vals[i];
    }
    keys.swap(kbuf);
    vals.swap(vbuf);
  }
}

void sort_edges(const std::vector<int32_t>& major,
                const std::vector<int32_t>& minor,
                std::vector<int64_t>& order) {
  const int64_t m = static_cast<int64_t>(major.size());
  std::vector<uint64_t> keys(m);
  for (int64_t i = 0; i < m; ++i)
    keys[i] = (static_cast<uint64_t>(static_cast<uint32_t>(major[i])) << 32) |
              static_cast<uint32_t>(minor[i]);
  order.resize(m);
  std::iota(order.begin(), order.end(), 0);
  radix_sort_pairs(keys, order);
}

void build(Graph& g, std::vector<int32_t>& srcs, std::vector<int32_t>& dsts,
           std::vector<float>& weights) {
  const int64_t m = static_cast<int64_t>(srcs.size());
  g.m = m;
  // CSR: stable sort by (src, dst) — matches np.lexsort((dsts, srcs)).
  std::vector<int64_t> order;
  sort_edges(srcs, dsts, order);
  g.csr_srcs.resize(m);
  g.csr_dsts.resize(m);
  g.csr_weights.resize(m);
  std::vector<int64_t> inv_csr(m);
  for (int64_t i = 0; i < m; ++i) {
    const int64_t e = order[i];
    g.csr_srcs[i] = srcs[e];
    g.csr_dsts[i] = dsts[e];
    g.csr_weights[i] = weights[e];
    inv_csr[e] = i;
  }
  g.row_offsets.assign(g.n + 1, 0);
  for (int64_t i = 0; i < m; ++i) g.row_offsets[g.csr_srcs[i] + 1]++;
  for (int64_t v = 0; v < g.n; ++v) g.row_offsets[v + 1] += g.row_offsets[v];

  // CSC: stable sort of the ORIGINAL edge indices by (dst, src) — matches
  // np.lexsort((srcs, dsts)) including tie order.
  sort_edges(dsts, srcs, order);
  g.csc_srcs.resize(m);
  g.csc_dsts.resize(m);
  g.csc_weights.resize(m);
  g.csc_eids.resize(m);
  for (int64_t i = 0; i < m; ++i) {
    const int64_t e = order[i];
    g.csc_srcs[i] = srcs[e];
    g.csc_dsts[i] = dsts[e];
    g.csc_weights[i] = weights[e];
    g.csc_eids[i] = static_cast<int32_t>(inv_csr[e]);
  }
  g.col_offsets.assign(g.n + 1, 0);
  for (int64_t i = 0; i < m; ++i) g.col_offsets[g.csc_dsts[i] + 1]++;
  for (int64_t v = 0; v < g.n; ++v) g.col_offsets[v + 1] += g.col_offsets[v];
}

}  // namespace

extern "C" {

// Parse + build.  Returns handle > 0, or <= 0 on failure.
// out_dims = {n, m}.
int mg_load_mtx(const char* path, int undirected, int transpose,
                int64_t* out_dims) {
  FILE* f = fopen(path, "rb");
  if (!f) return 0;
  fseek(f, 0, SEEK_END);
  const long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    return 0;
  }
  fclose(f);
  buf[size] = '\0';
  const char* p = buf.data();
  const char* end = buf.data() + size;

  // skip % comments
  while (p < end && *p == '%') {
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
  int64_t height = 0, width = 0, nnz = 0;
  p = parse_i64(p, end, &height);
  p = parse_i64(p, end, &width);
  p = parse_i64(p, end, &nnz);
  if (height <= 0 || nnz < 0) return 0;
  while (p < end && *p != '\n') ++p;
  if (p < end) ++p;

  std::vector<int32_t> srcs, dsts;
  std::vector<float> weights;
  const int64_t cap = undirected ? 2 * nnz : nnz;
  srcs.reserve(cap);
  dsts.reserve(cap);
  weights.reserve(cap);
  for (int64_t e = 0; e < nnz; ++e) {
    int64_t a = 0, b = 0;
    float w = 1.0f;
    bool has_w = false;
    p = parse_i64(p, end, &a);
    p = parse_i64(p, end, &b);
    p = parse_f32(p, end, &w, &has_w);
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
    if (a < 1 || b < 1 || a > height || b > height) return -1;
    if (!has_w) w = 1.0f;
    int32_t s = static_cast<int32_t>(a - 1);
    int32_t d = static_cast<int32_t>(b - 1);
    if (transpose) std::swap(s, d);
    srcs.push_back(s);
    dsts.push_back(d);
    weights.push_back(w);
  }
  // Undirected: every reversed edge after all the forward ones, the order
  // of from_edges(make_undirected=True).  The stable sorts keep that order
  // among equal (src, dst) keys, so a file holding both (u,v) and (v,u), or
  // a repeated edge, with different weights gives the NumPy path's weights
  // and csc_eids.  (mini_tpu's loader.cpp interleaves each edge with its
  // reverse, and there differs from its own NumPy path.)
  if (undirected) {
    for (int64_t e = 0; e < nnz; ++e) {
      const int32_t s = srcs[e], d = dsts[e];
      const float w = weights[e];
      srcs.push_back(d);
      dsts.push_back(s);
      weights.push_back(w);
    }
  }

  Graph* g = new Graph();
  g->n = height;
  build(*g, srcs, dsts, weights);
  out_dims[0] = g->n;
  out_dims[1] = g->m;
  std::lock_guard<std::mutex> lock(g_mutex);
  const int h = g_next_handle++;
  g_registry[h] = g;
  return h;
}

// Build from an in-memory edge list (0-based).  Used for parity testing and
// fast generator ingestion.
int mg_build(int64_t n, int64_t m, const int32_t* srcs, const int32_t* dsts,
             const float* weights, int64_t* out_dims) {
  std::vector<int32_t> s(srcs, srcs + m), d(dsts, dsts + m);
  std::vector<float> w;
  if (weights)
    w.assign(weights, weights + m);
  else
    w.assign(m, 1.0f);
  Graph* g = new Graph();
  g->n = n;
  build(*g, s, d, w);
  out_dims[0] = g->n;
  out_dims[1] = g->m;
  std::lock_guard<std::mutex> lock(g_mutex);
  const int h = g_next_handle++;
  g_registry[h] = g;
  return h;
}

int mg_fill(int handle, int64_t* row_offsets, int32_t* csr_dsts,
            int32_t* csr_srcs, float* csr_weights, int64_t* col_offsets,
            int32_t* csc_srcs, int32_t* csc_dsts, float* csc_weights,
            int32_t* csc_eids) {
  Graph* g = nullptr;
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    auto it = g_registry.find(handle);
    if (it == g_registry.end()) return 0;
    g = it->second;
  }
  memcpy(row_offsets, g->row_offsets.data(), (g->n + 1) * sizeof(int64_t));
  memcpy(csr_dsts, g->csr_dsts.data(), g->m * sizeof(int32_t));
  memcpy(csr_srcs, g->csr_srcs.data(), g->m * sizeof(int32_t));
  memcpy(csr_weights, g->csr_weights.data(), g->m * sizeof(float));
  memcpy(col_offsets, g->col_offsets.data(), (g->n + 1) * sizeof(int64_t));
  memcpy(csc_srcs, g->csc_srcs.data(), g->m * sizeof(int32_t));
  memcpy(csc_dsts, g->csc_dsts.data(), g->m * sizeof(int32_t));
  memcpy(csc_weights, g->csc_weights.data(), g->m * sizeof(float));
  memcpy(csc_eids, g->csc_eids.data(), g->m * sizeof(int32_t));
  return 1;
}

void mg_free(int handle) {
  std::lock_guard<std::mutex> lock(g_mutex);
  auto it = g_registry.find(handle);
  if (it != g_registry.end()) {
    delete it->second;
    g_registry.erase(it);
  }
}

}  // extern "C"
