// Native graph samplers for the host-side pipeline.
//
// The reference builds graphs through networkx Python loops
// (SA_RRG.py:59, HPR_pytorch_RRG.py:261, ER_BDCM_entropy.ipynb:280); at the
// framework's target scale (N=1e6 nodes feeding the device) graph construction is
// a real host bottleneck, so the ensemble samplers are implemented natively:
//
//  - rrg_edges: configuration-model stub pairing with conflict repair
//    (asymptotically uniform simple d-regular graphs, same scheme as the
//    numpy sampler in graphs.py).
//  - er_edges: G(n,p) via Batagelj–Brandes geometric skipping, O(E).
//
// The port's own copy of graphdyn/_native/graphgen.cpp, line for line, so
// the same seed gives the same edges in both packages. Exposed through
// ctypes (see build.py); all buffers are caller-allocated numpy arrays.
// Returns <0 on error.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <random>
#include <unordered_set>
#include <vector>

extern "C" {

// Sample a simple d-regular graph on n nodes. out_u/out_v must hold n*d/2
// entries. Returns 0 on success, -1 if repair failed, -2 on bad args.
int rrg_edges(int64_t n, int32_t d, uint64_t seed, int32_t* out_u,
              int32_t* out_v) {
  if (n <= 0 || d <= 0 || d >= n || (n * (int64_t)d) % 2 != 0) return -2;
  const int64_t E = n * (int64_t)d / 2;
  std::mt19937_64 rng(seed);

  std::vector<int32_t> stubs(2 * E);
  int64_t pos = 0;
  for (int64_t i = 0; i < n; ++i)
    for (int32_t k = 0; k < d; ++k) stubs[pos++] = (int32_t)i;
  std::shuffle(stubs.begin(), stubs.end(), rng);

  std::vector<int32_t> u(E), v(E);
  for (int64_t e = 0; e < E; ++e) {
    u[e] = stubs[2 * e];
    v[e] = stubs[2 * e + 1];
  }

  std::vector<int64_t> pool;
  std::vector<char> bad(E);
  std::unordered_set<int64_t> seen;
  seen.reserve(2 * E);

  for (int round = 0; round < 400; ++round) {
    // mark self-loops and duplicate copies (keep first occurrence)
    seen.clear();
    int64_t nbad = 0;
    for (int64_t e = 0; e < E; ++e) {
      int64_t a = std::min(u[e], v[e]), b = std::max(u[e], v[e]);
      int64_t code = a * n + b;
      bool is_bad = (u[e] == v[e]) || !seen.insert(code).second;
      bad[e] = is_bad;
      nbad += is_bad;
    }
    if (nbad == 0) {
      std::copy(u.begin(), u.end(), out_u);
      std::copy(v.begin(), v.end(), out_v);
      return 0;
    }

    // re-pair the bad stubs together with an equal number of good edges
    pool.clear();
    for (int64_t e = 0; e < E; ++e)
      if (bad[e]) pool.push_back(e);
    int64_t want_good = std::min<int64_t>(std::max<int64_t>(nbad, 8), E - nbad);
    std::uniform_int_distribution<int64_t> pick(0, E - 1);
    int64_t added = 0;
    while (added < want_good) {
      int64_t e = pick(rng);
      if (!bad[e]) {
        bad[e] = 1;  // marks as pooled so we don't add twice
        pool.push_back(e);
        ++added;
      }
    }
    std::vector<int32_t> ps;
    ps.reserve(2 * pool.size());
    for (int64_t e : pool) {
      ps.push_back(u[e]);
      ps.push_back(v[e]);
    }
    std::shuffle(ps.begin(), ps.end(), rng);
    for (size_t i = 0; i < pool.size(); ++i) {
      u[pool[i]] = ps[i];
      v[pool[i]] = ps[pool.size() + i];
    }
  }
  return -1;
}

// Sample G(n, p) edges by geometric skipping. Writes up to cap edges into
// out_u/out_v; returns the number of edges, or -1 if cap was too small.
int64_t er_edges(int64_t n, double p, uint64_t seed, int32_t* out_u,
                 int32_t* out_v, int64_t cap) {
  if (p <= 0.0 || n < 2) return 0;
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  int64_t m = 0;
  if (p >= 1.0) {
    for (int64_t i = 1; i < n; ++i)
      for (int64_t j = 0; j < i; ++j) {
        if (m >= cap) return -1;
        out_u[m] = (int32_t)j;
        out_v[m] = (int32_t)i;
        ++m;
      }
    return m;
  }
  // Batagelj–Brandes: enumerate lower-triangle pairs (i, j), j < i, with
  // geometric skips of mean 1/p
  const double logq = std::log(1.0 - p);
  int64_t i = 1, j = -1;
  while (i < n) {
    double r = unif(rng);
    j += 1 + (int64_t)std::floor(std::log(1.0 - r) / logq);
    while (j >= i && i < n) {
      j -= i;
      ++i;
    }
    if (i < n) {
      if (m >= cap) return -1;
      out_u[m] = (int32_t)j;
      out_v[m] = (int32_t)i;
      ++m;
    }
  }
  return m;
}

}  // extern "C"
