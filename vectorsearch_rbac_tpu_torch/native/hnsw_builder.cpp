// HNSW graph construction and alpha-RNG pruning, the host-side native builder.
//
// A copy of vectorsearch_rbac_tpu/native/hnsw_builder.cpp restricted to the
// four entry points the port's HNSW index calls: vsr_hnsw_build (the classic
// Malkov-Yashunin construction with the neighbour-selection heuristic, the
// "classic" builder), vsr_hnsw_build_acorn (the same construction with
// ACORN-gamma dense layer-0 lists, the "acorn" builder), vsr_rng_prune
// (the alpha-RNG prune that turns a kNN candidate graph into a navigable
// one, the "tpu" builder's host half) and vsr_insert_update (the online
// edge update of HNSWIndex.insert_rows and refine_rows). The exact-kNN
// oracle is not copied. Every function that is copied is the
// reference's, line for line, but one: vsr_rng_prune's per-node pass runs
// over node ranges in threads (each node reads only the inputs and writes
// only its own row), before the reverse-edge pass, which stays serial. One
// seed gives the same arrays from both libraries (tests/test_torch_graph.py
// and test_torch_hnsw_metrics.py hold them equal).
//
// Build: g++ -O3 -march=native -std=c++17 -fPIC -Wall -pthread -shared
// (the reference's Makefile flags and -pthread; native/__init__.py runs it
// at first use).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

using std::int32_t;
using std::int64_t;
using std::uint64_t;

inline float l2sq(const float* a, const float* b, int d) {
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
  int i = 0;
  for (; i + 4 <= d; i += 4) {
    float d0 = a[i] - b[i];
    float d1 = a[i + 1] - b[i + 1];
    float d2 = a[i + 2] - b[i + 2];
    float d3 = a[i + 3] - b[i + 3];
    acc0 += d0 * d0;
    acc1 += d1 * d1;
    acc2 += d2 * d2;
    acc3 += d3 * d3;
  }
  for (; i < d; ++i) {
    float dd = a[i] - b[i];
    acc0 += dd * dd;
  }
  return acc0 + acc1 + acc2 + acc3;
}

struct Cand {
  float dist;
  int32_t id;
};
struct CloserFirst {
  bool operator()(const Cand& a, const Cand& b) const { return a.dist > b.dist; }
};
struct FartherFirst {
  bool operator()(const Cand& a, const Cand& b) const { return a.dist < b.dist; }
};

// Graph storage: per level, flat (n, degree_cap) adjacency with -1 padding.
struct Graph {
  int64_t n;
  int d;
  int M;          // degree cap above layer 0
  int M0;         // degree cap at layer 0 (2*M; M_beta when dense)
  bool dense = false;  // ACORN-gamma layer-0 selection (see below)
  const float* vecs;
  std::vector<int32_t> levels;          // level per node
  std::vector<int32_t> nbr0;            // (n, M0)
  std::vector<std::vector<int32_t>> up; // per node: levels * M (level >= 1)
  int32_t entry = -1;
  int32_t max_level = -1;

  int32_t* neighbors(int32_t node, int level) {
    if (level == 0) return nbr0.data() + (int64_t)node * M0;
    return up[node].data() + (int64_t)(level - 1) * M;
  }
  int cap(int level) const { return level == 0 ? M0 : M; }
};

// Beam search at one level; returns up to ef closest candidates.
void search_layer(Graph& g, const float* q, int32_t entry, float entry_dist,
                  int level, int ef, std::vector<int32_t>& visit_stamp,
                  int32_t stamp, std::vector<Cand>& out) {
  std::priority_queue<Cand, std::vector<Cand>, CloserFirst> frontier;
  std::priority_queue<Cand, std::vector<Cand>, FartherFirst> best;
  frontier.push({entry_dist, entry});
  best.push({entry_dist, entry});
  visit_stamp[entry] = stamp;

  while (!frontier.empty()) {
    Cand c = frontier.top();
    if (c.dist > best.top().dist && (int)best.size() >= ef) break;
    frontier.pop();
    const int32_t* nb = g.neighbors(c.id, level);
    int cap = g.cap(level);
    for (int j = 0; j < cap; ++j) {
      int32_t v = nb[j];
      if (v < 0) break;
      if (visit_stamp[v] == stamp) continue;
      visit_stamp[v] = stamp;
      float dist = l2sq(q, g.vecs + (int64_t)v * g.d, g.d);
      if ((int)best.size() < ef || dist < best.top().dist) {
        frontier.push({dist, v});
        best.push({dist, v});
        if ((int)best.size() > ef) best.pop();
      }
    }
  }
  out.clear();
  out.reserve(best.size());
  while (!best.empty()) {
    out.push_back(best.top());
    best.pop();
  }
  std::reverse(out.begin(), out.end());  // closest first
}

// Malkov's neighbor-selection heuristic: keep candidates closer to the base
// point than to any already-selected neighbor.
void select_neighbors(const Graph& g, const std::vector<Cand>& cands, int M,
                      std::vector<Cand>& out) {
  out.clear();
  for (const Cand& c : cands) {
    if ((int)out.size() >= M) break;
    bool ok = true;
    const float* cv = g.vecs + (int64_t)c.id * g.d;
    for (const Cand& s : out) {
      float d_cs = l2sq(cv, g.vecs + (int64_t)s.id * g.d, g.d);
      if (d_cs < c.dist) {
        ok = false;
        break;
      }
    }
    if (ok) out.push_back(c);
  }
}

// ACORN-gamma style dense selection (reference acorn_benchmark/src/
// index_creation.cpp:105 gamma=12, M_beta=64): the heuristic keeps a
// navigable core of M edges, then the nearest PRUNED candidates fill the
// list up to cap_total. Predicate-filtered search discards inadmissible
// neighbors, so the denser list keeps enough admissible edges for the
// traversal to make progress at low selectivity.
void select_neighbors_dense(const Graph& g, const std::vector<Cand>& cands,
                            int M, int cap_total, std::vector<Cand>& out) {
  out.clear();
  std::vector<Cand> pruned;
  for (const Cand& c : cands) {
    if ((int)out.size() >= cap_total) break;
    bool ok = true;
    const float* cv = g.vecs + (int64_t)c.id * g.d;
    if ((int)out.size() < M) {
      for (const Cand& s : out) {
        float d_cs = l2sq(cv, g.vecs + (int64_t)s.id * g.d, g.d);
        if (d_cs < c.dist) {
          ok = false;
          break;
        }
      }
    }
    if (ok && (int)out.size() < M) {
      out.push_back(c);
    } else {
      pruned.push_back(c);
    }
  }
  for (const Cand& c : pruned) {
    if ((int)out.size() >= cap_total) break;
    out.push_back(c);
  }
}

void link(Graph& g, int32_t a, int level, const std::vector<Cand>& sel,
          std::vector<Cand>& scratch, std::vector<Cand>& scratch2) {
  int32_t* nb = g.neighbors(a, level);
  int cap = g.cap(level);
  int m = std::min((int)sel.size(), cap);
  for (int j = 0; j < m; ++j) nb[j] = sel[j].id;
  for (int j = m; j < cap; ++j) nb[j] = -1;

  // reverse edges with shrink-by-heuristic when over capacity
  const float* av = g.vecs + (int64_t)a * g.d;
  for (int j = 0; j < m; ++j) {
    int32_t b = sel[j].id;
    int32_t* bn = g.neighbors(b, level);
    int used = 0;
    while (used < cap && bn[used] >= 0) ++used;
    if (used < cap) {
      bn[used] = a;
      continue;
    }
    // over capacity: re-select among existing + new
    const float* bv = g.vecs + (int64_t)b * g.d;
    scratch.clear();
    scratch.push_back({l2sq(bv, av, g.d), a});
    for (int t = 0; t < used; ++t) {
      scratch.push_back({l2sq(bv, g.vecs + (int64_t)bn[t] * g.d, g.d), bn[t]});
    }
    std::sort(scratch.begin(), scratch.end(),
              [](const Cand& x, const Cand& y) { return x.dist < y.dist; });
    if (g.dense && level == 0) {
      select_neighbors_dense(g, scratch, g.M, cap, scratch2);
    } else {
      select_neighbors(g, scratch, cap, scratch2);
    }
    int t = 0;
    for (; t < (int)scratch2.size(); ++t) bn[t] = scratch2[t].id;
    for (; t < cap; ++t) bn[t] = -1;
  }
}

}  // namespace

// Shared construction body. m_beta > 2*M turns on ACORN-gamma dense
// layer-0 lists (layer-0 adjacency then has m_beta columns).
static int hnsw_build_impl(const float* vecs, int64_t n, int d, int M,
                           int m_beta, int ef_construction, uint64_t seed,
                           int32_t* neighbors0, int32_t* levels_out,
                           int32_t* entry_out) {
  if (n <= 0 || d <= 0 || M < 2 || m_beta < 2 * M) return -1;
  Graph g;
  g.n = n;
  g.d = d;
  g.M = M;
  g.M0 = m_beta;
  g.dense = m_beta > 2 * M;
  g.vecs = vecs;
  g.levels.assign(n, 0);
  g.nbr0.assign((int64_t)n * g.M0, -1);
  g.up.resize(n);

  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  const double mL = 1.0 / std::log(std::max(2, M));

  std::vector<int32_t> visit_stamp(n, -1);
  int32_t stamp = 0;
  std::vector<Cand> found, sel, scratch, scratch2;

  for (int64_t i = 0; i < n; ++i) {
    double u = unif(rng);
    int level = (int)(-std::log(std::max(u, 1e-12)) * mL);
    g.levels[i] = level;
    if (level > 0) g.up[i].assign((int64_t)level * M, -1);

    if (g.entry < 0) {
      g.entry = (int32_t)i;
      g.max_level = level;
      continue;
    }

    const float* q = vecs + i * (int64_t)d;
    int32_t ep = g.entry;
    float ep_dist = l2sq(q, vecs + (int64_t)ep * d, d);

    // greedy descent through levels above the node's level
    for (int l = g.max_level; l > level; --l) {
      bool improved = true;
      while (improved) {
        improved = false;
        const int32_t* nb = g.neighbors(ep, l);
        for (int j = 0; j < g.cap(l); ++j) {
          int32_t v = nb[j];
          if (v < 0) break;
          float dist = l2sq(q, vecs + (int64_t)v * d, d);
          if (dist < ep_dist) {
            ep_dist = dist;
            ep = v;
            improved = true;
          }
        }
      }
    }

    // ef-search + connect at each level from min(level, max_level) down
    for (int l = std::min(level, (int)g.max_level); l >= 0; --l) {
      ++stamp;
      search_layer(g, q, ep, ep_dist, l, ef_construction, visit_stamp, stamp,
                   found);
      if (g.dense && l == 0) {
        select_neighbors_dense(g, found, g.M, g.M0, sel);
      } else {
        select_neighbors(g, found, g.M, sel);
        if ((int)sel.size() > g.M && l > 0) sel.resize(g.M);
      }
      link(g, (int32_t)i, l, sel, scratch, scratch2);
      if (!found.empty()) {
        ep = found[0].id;
        ep_dist = found[0].dist;
      }
    }

    if (level > g.max_level) {
      g.max_level = level;
      g.entry = (int32_t)i;
    }
  }

  std::memcpy(neighbors0, g.nbr0.data(), sizeof(int32_t) * (size_t)n * g.M0);
  std::memcpy(levels_out, g.levels.data(), sizeof(int32_t) * (size_t)n);
  *entry_out = g.entry;
  return g.max_level;
}

extern "C" {

// Build a full HNSW graph. Outputs:
//   neighbors0: int32 (n, 2*M) layer-0 adjacency, -1 padded
//   levels:     int32 (n,)
//   entry:      int32 (1,) entry point node id
// Returns max level, or -1 on error.
int vsr_hnsw_build(const float* vecs, int64_t n, int d, int M,
                   int ef_construction, uint64_t seed, int32_t* neighbors0,
                   int32_t* levels_out, int32_t* entry_out) {
  return hnsw_build_impl(vecs, n, d, M, 2 * M, ef_construction, seed,
                         neighbors0, levels_out, entry_out);
}

// ACORN-gamma densified build (reference acorn_benchmark/src/
// index_creation.cpp:105): layer-0 lists have m_beta columns — a
// heuristic-selected navigable core of M edges plus the nearest pruned
// candidates — so predicate-filtered traversal keeps admissible edges
// at low selectivity. neighbors0 must be int32 (n, m_beta).
int vsr_hnsw_build_acorn(const float* vecs, int64_t n, int d, int M,
                         int m_beta, int ef_construction, uint64_t seed,
                         int32_t* neighbors0, int32_t* levels_out,
                         int32_t* entry_out) {
  return hnsw_build_impl(vecs, n, d, M, m_beta, ef_construction, seed,
                         neighbors0, levels_out, entry_out);
}

// Alpha-RNG prune of a device-computed kNN graph (Vamana/DiskANN-style):
// for each node, keep up to M of its K candidates such that no kept
// neighbor is alpha-dominated by an earlier kept one; then add reverse
// edges up to capacity. knn: int32 (n, K) nearest-neighbor ids (self
// entries ignored), -1 padded. out: int32 (n, M_out) with M_out = 2*M.
int vsr_rng_prune(const float* vecs, int64_t n, int d, const int32_t* knn,
                  int K, int M, float alpha, int32_t* out) {
  if (n <= 0 || d <= 0 || M < 1 || K < 1) return -1;
  const int M_out = 2 * M;
  std::vector<int32_t> deg(n, 0);
  for (int64_t i = 0; i < n; ++i) {
    int32_t* row = out + i * M_out;
    for (int j = 0; j < M_out; ++j) row[j] = -1;
  }

  auto select = [&](int64_t lo, int64_t hi) {
    std::vector<std::pair<float, int32_t>> cands;
    cands.reserve(K);
    for (int64_t i = lo; i < hi; ++i) {
      const float* vi = vecs + i * (int64_t)d;
      cands.clear();
      for (int j = 0; j < K; ++j) {
        int32_t v = knn[i * K + j];
        if (v < 0 || v == (int32_t)i) continue;
        cands.push_back({l2sq(vi, vecs + (int64_t)v * d, d), v});
      }
      std::sort(cands.begin(), cands.end());
      int32_t* row = out + i * M_out;
      int kept = 0;
      for (const auto& [dist, v] : cands) {
        if (kept >= M) break;
        bool dominated = false;
        const float* vv = vecs + (int64_t)v * d;
        for (int t = 0; t < kept; ++t) {
          float d_sv = l2sq(vv, vecs + (int64_t)row[t] * d, d);
          if (d_sv * alpha < dist) {
            dominated = true;
            break;
          }
        }
        if (!dominated) row[kept++] = v;
      }
      deg[i] = kept;
    }
  };
  // node ranges of at least 4096 nodes, one a hardware thread
  const int64_t threads = std::max<int64_t>(
      1, std::min<int64_t>(std::thread::hardware_concurrency(),
                           (n + 4095) / 4096));
  std::vector<std::thread> pool;
  for (int64_t t = 1; t < threads; ++t) {
    const int64_t lo = n * t / threads, hi = n * (t + 1) / threads;
    try {
      pool.emplace_back(select, lo, hi);
    } catch (...) {  // no thread to be had: this range on the caller's
      select(lo, hi);
    }
  }
  select(0, n / threads);
  for (auto& th : pool) th.join();

  // reverse edges (undirected navigability), capped at M_out
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* row = out + i * M_out;
    for (int j = 0; j < M_out && row[j] >= 0; ++j) {
      int32_t v = row[j];
      if (deg[v] < M_out) {
        int32_t* vrow = out + (int64_t)v * M_out;
        // avoid duplicates
        bool dup = false;
        for (int t = 0; t < deg[v]; ++t)
          if (vrow[t] == (int32_t)i) {
            dup = true;
            break;
          }
        if (!dup) vrow[deg[v]++] = (int32_t)i;
      }
    }
  }
  return 0;
}

// Online-insert edge update: the host-side hot loop of
// HNSWIndex.insert_rows (forward alpha-RNG prune of each new node's
// candidate list + reverse edges with overflow replace-worst), moved to
// C++ for bulk-insert throughput. Graph rows are LOCAL ids; `vmap` maps a
// local id to its row in `vecs` (the shared arena for logical/pointer
// indexes, an identity map for physical copies). `cand` holds each new
// node's candidate local ids from the device beam search (-1 pads). New
// nodes are local ids n_old..n_old+n_new-1, in order. The shared-candidate
// peer rule links same-batch nodes that listed a common candidate (they
// are invisible to the pre-insert graph search). Changed OLD rows are
// reported in `changed` (capacity n_new*m + n_new; count in *n_changed).
// `nodes`: when non-null, the function runs in REFINE mode over these
// existing local ids (insert-path Vamana refinement): candidates add the
// node's CURRENT neighbor list, reverse edges skip targets already linked,
// and the peer rule is off (every node is already visible in the graph).
// In insert mode (nodes == null) the nodes are n_old..n_old+n_new-1.
int vsr_insert_update(const float* vecs, int64_t n_vec, int d,
                      const int32_t* vmap, int32_t* graph, int64_t npad,
                      int m0, const int32_t* cand, int n_new, int C,
                      int64_t n_old, int M, float alpha, int32_t* changed,
                      int32_t* n_changed, const int32_t* nodes) {
  const bool refine = nodes != nullptr;
  if (d <= 0 || m0 < 1 || n_new < 1 || C < 1 || M < 1) return -1;
  if (!refine && n_old + n_new > npad) return -2;
  const int cap = *n_changed;
  int n_out = 0;
  std::vector<char> marked(npad, 0);
  std::unordered_map<int32_t, std::vector<int32_t>> seen_by_cand;
  std::vector<int32_t> cids;
  std::vector<std::pair<double, int32_t>> order;
  std::vector<int32_t> kept;

  auto vrow = [&](int32_t local) -> const float* {
    int32_t r = vmap[local];
    return vecs + (int64_t)r * d;
  };
  auto l2d = [&](const float* a, const float* b) -> double {
    double s = 0.0;
    for (int t = 0; t < d; ++t) {
      double diff = (double)a[t] - (double)b[t];
      s += diff * diff;
    }
    return s;
  };

  for (int j = 0; j < n_new; ++j) {
    const int32_t nid = refine ? nodes[j] : (int32_t)(n_old + j);
    const float* vn = vrow(nid);
    int32_t* row = graph + (int64_t)nid * m0;
    cids.clear();
    // candidates (+ current neighbors in refine mode; dedup via a small
    // linear scan: candidate lists are <= C + m0 + peers, tens of entries)
    for (int t = 0; t < C; ++t) {
      int32_t c = cand[(int64_t)j * C + t];
      if (c < 0 || c == nid) continue;
      bool dup = false;
      for (int32_t x : cids)
        if (x == c) { dup = true; break; }
      if (!dup) cids.push_back(c);
    }
    if (refine) {
      for (int t = 0; t < m0; ++t) {
        int32_t c = row[t];
        if (c < 0 || c == nid) continue;
        bool dup = false;
        for (int32_t x : cids)
          if (x == c) { dup = true; break; }
        if (!dup) cids.push_back(c);
      }
    } else {
      // shared-candidate peers: same-batch nodes that listed a common
      // candidate (invisible to the pre-insert graph search)
      size_t n_direct = cids.size();
      for (size_t t = 0; t < n_direct; ++t) {
        auto it = seen_by_cand.find(cids[t]);
        if (it == seen_by_cand.end()) continue;
        for (int32_t p : it->second) {
          bool dup = false;
          for (int32_t x : cids)
            if (x == p) { dup = true; break; }
          if (!dup && p != nid) cids.push_back(p);
        }
      }
      for (size_t t = 0; t < n_direct; ++t)
        seen_by_cand[cids[t]].push_back(nid);
    }

    if (cids.empty()) {
      if (!refine)
        for (int t = 0; t < m0; ++t) row[t] = -1;
      continue;
    }
    for (int t = 0; t < m0; ++t) row[t] = -1;

    order.clear();
    for (int32_t c : cids) order.push_back({l2d(vn, vrow(c)), c});
    std::stable_sort(order.begin(), order.end());
    kept.clear();
    for (const auto& [dist, c] : order) {
      if ((int)kept.size() >= M) break;
      bool dominated = false;
      const float* vc = vrow(c);
      for (int32_t t : kept) {
        if (l2d(vc, vrow(t)) * alpha < dist) { dominated = true; break; }
      }
      if (!dominated) kept.push_back(c);
    }
    for (size_t t = 0; t < kept.size(); ++t) row[t] = kept[t];

    // reverse edges: free slot, else replace the farthest if closer
    // (refine mode: skip targets that already link back)
    for (int32_t c : kept) {
      int32_t* crow = graph + (int64_t)c * m0;
      if (refine) {
        bool linked = false;
        for (int t = 0; t < m0; ++t)
          if (crow[t] == nid) { linked = true; break; }
        if (linked) continue;
      }
      int slot = -1;
      for (int t = 0; t < m0; ++t)
        if (crow[t] < 0) { slot = t; break; }
      bool wrote = false;
      if (slot >= 0) {
        crow[slot] = nid;
        wrote = true;
      } else {
        const float* vc = vrow(c);
        double worst_d = -1.0;
        int worst_t = -1;
        for (int t = 0; t < m0; ++t) {
          double dn = l2d(vrow(crow[t]), vc);
          if (dn > worst_d) { worst_d = dn; worst_t = t; }
        }
        if (l2d(vn, vc) < worst_d) {
          crow[worst_t] = nid;
          wrote = true;
        }
      }
      if (wrote && (refine || c < (int32_t)n_old) && !marked[c]) {
        marked[c] = 1;
        if (n_out < cap) changed[n_out++] = c;
      }
    }
    if (refine && !marked[nid]) {
      marked[nid] = 1;
      if (n_out < cap) changed[n_out++] = nid;
    }
  }
  *n_changed = n_out;
  return 0;
}

}  // extern "C"
