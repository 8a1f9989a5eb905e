// Decision-boundary lattice enumeration (native core).
//
// Enumerates all integer vectors g in Z_{>=0}^n with sum(g) = T and
// g[0] == max(g[1..n-1]) — the T-lattice points on the simplex where the
// label probability ties the maximum wrong probability.  This is the grid
// the certifiers sweep.  A direct DFS with bound pruning and a memoised
// bounded-composition counter; n = 10, T = 40 (41,320,837 rows) takes about
// a second.  Host code: built with g++ -O3 at first use, see
// fiode_tpu_torch/ops/_build.py.
//
// C ABI (loaded via ctypes from fiode_tpu_torch/verify/grid.py):
//   count_boundary(n, T)        -> number of lattice points
//   enum_boundary(n, T, out)    -> writes (count, n) int16 row-major; returns
//                                  the number of rows written.
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// count of (g_1..g_k) with sum s and each g_i <= m  (bounded compositions)
struct Key {
  int k, s, m;
  bool operator==(const Key& o) const { return k == o.k && s == o.s && m == o.m; }
};
struct KeyHash {
  size_t operator()(const Key& k) const {
    return ((size_t)k.k << 40) ^ ((size_t)k.s << 20) ^ (size_t)k.m;
  }
};

int64_t bounded_comps(int k, int s, int m,
                      std::unordered_map<Key, int64_t, KeyHash>& memo) {
  if (s < 0) return 0;
  if (k == 0) return s == 0 ? 1 : 0;
  if ((int64_t)m * k < s) return 0;
  if (m == 0) return s == 0 ? 1 : 0;
  Key key{k, s, m};
  auto it = memo.find(key);
  if (it != memo.end()) return it->second;
  int64_t total = 0;
  for (int v = 0; v <= m && v <= s; ++v)
    total += bounded_comps(k - 1, s - v, m, memo);
  memo[key] = total;
  return total;
}

void enum_rows(int pos, int n, int remaining, int m, bool used_m,
               std::vector<int16_t>& cur, int16_t* out, int64_t& written) {
  int left = n - pos;  // coords still to fill (indices pos..n-1)
  if (left == 0) {
    if (remaining == 0 && used_m) {
      std::memcpy(out + written * n, cur.data(), n * sizeof(int16_t));
      ++written;
    }
    return;
  }
  if (remaining < 0) return;
  if ((int64_t)m * left < remaining) return;
  // if m not yet used, at least one remaining coord must hit m
  if (!used_m && remaining < m) return;
  int hi = m < remaining ? m : remaining;
  for (int v = 0; v <= hi; ++v) {
    cur[pos] = (int16_t)v;
    enum_rows(pos + 1, n, remaining - v, m, used_m || v == m, cur, out, written);
  }
  cur[pos] = 0;
}

}  // namespace

extern "C" {

int64_t count_boundary(int n, int T) {
  // sum over the tied max m: vectors with g0 = m, others sum T-m, max
  // exactly m  =>  bounded(<=m) - bounded(<=m-1)
  std::unordered_map<Key, int64_t, KeyHash> memo;
  int64_t total = 0;
  for (int m = 0; m <= T; ++m) {
    int64_t le_m = bounded_comps(n - 1, T - m, m, memo);
    int64_t le_m1 = m > 0 ? bounded_comps(n - 1, T - m, m - 1, memo) : 0;
    total += le_m - le_m1;
  }
  return total;
}

int64_t enum_boundary(int n, int T, int16_t* out) {
  std::vector<int16_t> cur(n, 0);
  int64_t written = 0;
  for (int m = 0; m <= T; ++m) {
    cur[0] = (int16_t)m;
    // used_m flips when some coordinate hits m (v == m covers m == 0 too)
    enum_rows(1, n, T - m, m, /*used_m=*/false, cur, out, written);
  }
  return written;
}

}  // extern "C"
