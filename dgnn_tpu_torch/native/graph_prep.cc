// Native host graph preprocessing for dgnn_tpu_torch: counting-sort
// CSR/CSC construction, degree-bin slot fill, hub-block mask fill and the
// count of its tile rows' edges, and the xoshiro256** R-MAT generator.
//
// A copy of dgnn_tpu/native/graph_prep.cc.  The R-MAT generator here draws
// from its own PRNG, so it gives another graph than the numpy R-MAT of
// data/synthetic.py, which the reddit build uses (as the JAX package's
// does); nothing in the port's data path calls it.  Graph
// preprocessing is one-time host work, so the tool is an O(E) counting sort
// in C++: numpy's lexsort is comparison-based and many times slower on
// large edge lists.
//
// Built with g++ at first use and bound with ctypes (native/__init__.py),
// which checks every size and index before it passes a pointer here.  All
// functions are single-threaded C++17; indices are int64 on input, int32
// on the per-graph outputs.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Sort edges by (dst, src) into CSR over destination rows.
//   row_ptr: out [n+1] int64
//   col_ind: out [e] int32 (source node of CSR edge)
// Two stable counting passes (LSD radix over src then dst).
void dgnn_coo_to_csr(int64_t n, int64_t e, const int64_t* src,
                     const int64_t* dst, int64_t* row_ptr, int32_t* col_ind) {
  // pass 1: stable counting sort of edge ids by src
  std::vector<int64_t> cnt(n + 1, 0);
  for (int64_t i = 0; i < e; ++i) cnt[src[i] + 1]++;
  for (int64_t i = 0; i < n; ++i) cnt[i + 1] += cnt[i];
  std::vector<int64_t> by_src(e);
  {
    std::vector<int64_t> pos(cnt.begin(), cnt.end() - 1);
    for (int64_t i = 0; i < e; ++i) by_src[pos[src[i]]++] = i;
  }
  // pass 2: stable counting sort of by_src by dst
  std::memset(cnt.data(), 0, sizeof(int64_t) * (n + 1));
  for (int64_t i = 0; i < e; ++i) cnt[dst[i] + 1]++;
  for (int64_t i = 0; i < n; ++i) cnt[i + 1] += cnt[i];
  std::memcpy(row_ptr, cnt.data(), sizeof(int64_t) * (n + 1));
  std::vector<int64_t> pos(cnt.begin(), cnt.end() - 1);
  for (int64_t k = 0; k < e; ++k) {
    int64_t eid = by_src[k];
    col_ind[pos[dst[eid]]++] = static_cast<int32_t>(src[eid]);
  }
}

// Transpose CSR -> CSC, emitting the CSR edge id stored at each CSC slot
// (the `permute` contract of graph/build.py).  One counting pass;
// stability over CSR order gives within-column row sorting.
void dgnn_csr_to_csc_permute(int64_t n, int64_t e, const int64_t* row_ptr,
                             const int32_t* col_ind, int64_t* col_ptr,
                             int32_t* row_ind, int32_t* permute) {
  std::vector<int64_t> cnt(n + 1, 0);
  for (int64_t i = 0; i < e; ++i) cnt[col_ind[i] + 1]++;
  for (int64_t i = 0; i < n; ++i) cnt[i + 1] += cnt[i];
  std::memcpy(col_ptr, cnt.data(), sizeof(int64_t) * (n + 1));
  std::vector<int64_t> pos(cnt.begin(), cnt.end() - 1);
  for (int64_t r = 0; r < n; ++r) {
    for (int64_t j = row_ptr[r]; j < row_ptr[r + 1]; ++j) {
      int64_t p = pos[col_ind[j]]++;
      row_ind[p] = static_cast<int32_t>(r);
      permute[p] = static_cast<int32_t>(j);
    }
  }
}

// Fill dense padded slot tables for degree binning (graph/binning.py):
// segment s covers CSR slots [starts[s], starts[s]+counts[s]).
void dgnn_bin_fill(int64_t num_seg, int64_t width, const int64_t* starts,
                   const int64_t* counts, const int32_t* col_ind,
                   const int64_t* edge_ids, int32_t* nbr, int32_t* edge) {
  for (int64_t s = 0; s < num_seg; ++s) {
    int64_t base = s * width;
    int64_t st = starts[s];
    int64_t c = counts[s];
    for (int64_t j = 0; j < c; ++j) {
      nbr[base + j] = col_ind[st + j];
      edge[base + j] = static_cast<int32_t>(edge_ids[st + j]);
    }
    for (int64_t j = c; j < width; ++j) {
      nbr[base + j] = 0;
      edge[base + j] = 0;
    }
  }
}

// R-MAT (recursive matrix) power-law edge generator, xoshiro256** PRNG
// seeded by splitmix64.  Draws e/2+1 directed edges, each one bit of its
// (u, v) a level over ceil(log2 n) levels (at least one), scrambles the ids
// by a fixed odd multiplier modulo n, and writes the first e of the edges
// and their mirrors: (src, dst)[i] = (u_i, v_i) and, from e/2+1 on,
// (v_i, u_i).  Bit for bit the generator of dgnn_tpu/native/graph_prep.cc.
static inline uint64_t rotl(uint64_t x, int k) {
  return (x << k) | (x >> (64 - k));
}

void dgnn_rmat(int64_t n, int64_t e, uint64_t seed, double a, double b,
               double c, int64_t* src, int64_t* dst) {
  uint64_t s[4];
  // splitmix64 seeding
  uint64_t z = seed + 0x9E3779B97F4A7C15ULL;
  for (int i = 0; i < 4; ++i) {
    z += 0x9E3779B97F4A7C15ULL;
    uint64_t t = z;
    t = (t ^ (t >> 30)) * 0xBF58476D1CE4E5B9ULL;
    t = (t ^ (t >> 27)) * 0x94D049BB133111EBULL;
    s[i] = t ^ (t >> 31);
  }
  auto next = [&]() -> uint64_t {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  };
  int scale = 1;
  while ((1LL << scale) < n) ++scale;
  const int64_t half = e / 2 + 1;
  const double inv = 1.0 / 18446744073709551616.0;  // 2^-64
  // node-id scramble: fixed odd multiplier hash (keeps hubs spread out)
  auto scramble = [&](int64_t v) -> int64_t {
    uint64_t x = static_cast<uint64_t>(v) * 0x9E3779B97F4A7C15ULL;
    x ^= x >> 29;
    return static_cast<int64_t>(x % static_cast<uint64_t>(n));
  };
  for (int64_t i = 0; i < half; ++i) {
    int64_t u = 0, v = 0;
    for (int lev = 0; lev < scale; ++lev) {
      double r = static_cast<double>(next()) * inv;
      int down = (r >= a && r < a + b) || (r >= a + b + c);
      int right = r >= a + b;
      u = (u << 1) | down;
      v = (v << 1) | right;
    }
    u = scramble(u % n);
    v = scramble(v % n);
    if (i < e) { src[i] = u; dst[i] = v; }
    int64_t j = half + i;
    if (j < e) { src[j] = v; dst[j] = u; }
  }
}

// Dense hub-block mask fill: set adjacency bits of the [R, C] block directly
// in the bit-plane-packed layout (graph/hub.py pack_mask_bits semantics):
// within each ct-column tile, the bit of logical column slot j lives in byte
// j % (ct/8), bit j / (ct/8).  The numpy path materialises an [R, C] bool
// image, permutes and packs it; this is a single O(E) pass.
void dgnn_dense_mask_fill(
    int64_t num_edges, int64_t cpad, int64_t ct,
    const int64_t* rows_local,   // [E] dense row index per edge
    const int64_t* cols_local,   // [E] dense column slot per edge
    uint8_t* mask)               // [R, cpad/8] zero-initialized
{
  const int64_t cb = ct / 8;           // bytes per tile
  const int64_t row_bytes = cpad / 8;
  for (int64_t e = 0; e < num_edges; ++e) {
    const int64_t j = cols_local[e];
    const int64_t tile = j / ct;
    const int64_t in_tile = j % ct;
    const int64_t byte = tile * cb + in_tile % cb;
    const int64_t bit = in_tile / cb;
    mask[rows_local[e] * row_bytes + byte] |= (uint8_t)(1u << bit);
  }
}

// Set bits of each tile row of a packed hub-block mask: counts[i] is the
// popcount of the row_bytes bytes of row i (rows = entries x tile rows, as
// the mask lies in memory; row_bytes a multiple of 8).  One pass over the
// mask, 8 bytes at a time; on x86-64 with the POPCNT instruction, which
// counted 2.5x faster than the portable sequence g++ emits without it
// (1.5 GB, the Reddit stand-in's two masks, in about 0.3 s).
#if defined(__x86_64__)
__attribute__((target("popcnt")))
#endif
void dgnn_tile_row_edges(int64_t rows, int64_t row_bytes,
                         const uint8_t* mask, int32_t* counts) {
  const int64_t words = row_bytes / 8;
  for (int64_t i = 0; i < rows; ++i) {
    const uint8_t* m = mask + i * row_bytes;
    int32_t n = 0;
    for (int64_t w = 0; w < words; ++w) {
      uint64_t v;
      std::memcpy(&v, m + 8 * w, 8);
      n += __builtin_popcountll(v);
    }
    counts[i] = n;
  }
}

}  // extern "C"
