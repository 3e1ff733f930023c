// femcore: native host-runtime core for fembrain_tpu.
//
// The reference implements its host runtime in C++ (VolMesh topology DB,
// src/deformable/VolMesh.cpp; haptic ring propagation,
// src/deformable/Deformable.cpp:634-706). The TPU compute path lives in
// JAX/XLA; this library provides the host-side topology kernels that sit
// between frames (adjacency construction, BFS ring force propagation,
// unique-edge extraction with canonical per-cell ordering, invariant
// checks) at native speed for large meshes.
//
// C ABI only — consumed via ctypes (fembrain_tpu/native/__init__.py).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <functional>
#include <queue>
#include <unordered_map>
#include <vector>

namespace {

struct Adjacency {
  int32_t n_nodes = 0;
  std::vector<int32_t> offsets;  // CSR [n_nodes + 1]
  std::vector<int32_t> neighbors;
};

inline uint64_t edge_key(int32_t a, int32_t b) {
  if (a > b) std::swap(a, b);
  return (static_cast<uint64_t>(a) << 32) | static_cast<uint32_t>(b);
}

// Canonical cell edge slots (mesh/volmesh.py CELL_EDGES; derived from the
// reference's cut tables, TetSubdivider.cpp:21-44).
constexpr int kCellEdges[6][2] = {{1, 2}, {2, 3}, {1, 3},
                                  {0, 2}, {0, 3}, {0, 1}};

}  // namespace

extern "C" {

// ---------------------------------------------------------------- adjacency
void* fem_adj_build(int32_t n_nodes, int32_t n_tets, const int32_t* tets) {
  auto* adj = new Adjacency();
  adj->n_nodes = n_nodes;
  std::vector<std::vector<int32_t>> nbr(n_nodes);
  for (int32_t t = 0; t < n_tets; ++t) {
    const int32_t* c = tets + 4 * t;
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j)
        if (i != j) nbr[c[i]].push_back(c[j]);
  }
  adj->offsets.resize(n_nodes + 1, 0);
  for (int32_t v = 0; v < n_nodes; ++v) {
    auto& list = nbr[v];
    std::sort(list.begin(), list.end());
    list.erase(std::unique(list.begin(), list.end()), list.end());
    adj->offsets[v + 1] = adj->offsets[v] + static_cast<int32_t>(list.size());
  }
  adj->neighbors.resize(adj->offsets.back());
  for (int32_t v = 0; v < n_nodes; ++v)
    std::copy(nbr[v].begin(), nbr[v].end(),
              adj->neighbors.begin() + adj->offsets[v]);
  return adj;
}

void fem_adj_free(void* p) { delete static_cast<Adjacency*>(p); }

int32_t fem_adj_degree(void* p, int32_t node) {
  auto* adj = static_cast<Adjacency*>(p);
  return adj->offsets[node + 1] - adj->offsets[node];
}

// BFS ring force propagation with linear falloff (reference
// Deformable::applyHapticForces, Deformable.cpp:634-706).
// out_forces: [n_nodes * 3], accumulated.
void fem_adj_ring_forces(void* p, int32_t n_contacts, const int32_t* idx,
                         const double* forces, int32_t radius,
                         double* out_forces) {
  auto* adj = static_cast<Adjacency*>(p);
  std::vector<int32_t> dist(adj->n_nodes);
  for (int32_t c = 0; c < n_contacts; ++c) {
    std::fill(dist.begin(), dist.end(), -1);
    std::queue<int32_t> q;
    dist[idx[c]] = 0;
    q.push(idx[c]);
    const double* f = forces + 3 * c;
    while (!q.empty()) {
      int32_t u = q.front();
      q.pop();
      double w = 1.0 - static_cast<double>(dist[u]) / radius;
      out_forces[3 * u + 0] += f[0] * w;
      out_forces[3 * u + 1] += f[1] * w;
      out_forces[3 * u + 2] += f[2] * w;
      if (dist[u] + 1 >= radius) continue;
      for (int32_t k = adj->offsets[u]; k < adj->offsets[u + 1]; ++k) {
        int32_t v = adj->neighbors[k];
        if (dist[v] < 0) {
          dist[v] = dist[u] + 1;
          q.push(v);
        }
      }
    }
  }
}

// ------------------------------------------------------------------- edges
// Unique edge extraction + per-cell canonical edge slots.
// out_edges capacity: 2 * 6 * n_tets ints; returns edge count.
// out_cell_edges: [n_tets * 6] edge indices in canonical slot order.
int32_t fem_build_edges(int32_t n_tets, const int32_t* tets,
                        int32_t* out_edges, int32_t* out_cell_edges) {
  std::unordered_map<uint64_t, int32_t> map;
  map.reserve(static_cast<size_t>(n_tets) * 4);
  int32_t n_edges = 0;
  for (int32_t t = 0; t < n_tets; ++t) {
    const int32_t* c = tets + 4 * t;
    for (int s = 0; s < 6; ++s) {
      int32_t a = c[kCellEdges[s][0]];
      int32_t b = c[kCellEdges[s][1]];
      uint64_t key = edge_key(a, b);
      auto it = map.find(key);
      int32_t e;
      if (it == map.end()) {
        e = n_edges++;
        map.emplace(key, e);
        out_edges[2 * e + 0] = a;
        out_edges[2 * e + 1] = b;
      } else {
        e = it->second;
      }
      out_cell_edges[6 * t + s] = e;
    }
  }
  return n_edges;
}

// -------------------------------------------------------------- invariants
// Fast mesh invariant check (reference TestVolMesh::tst_correct_elements):
// returns number of violations (duplicate corner nodes, out-of-range ids,
// |volume| < eps given positions).
int32_t fem_check_cells(int32_t n_nodes, int32_t n_tets, const int32_t* tets,
                        const double* pos, double eps) {
  int32_t bad = 0;
  for (int32_t t = 0; t < n_tets; ++t) {
    const int32_t* c = tets + 4 * t;
    bool ok = true;
    for (int i = 0; i < 4 && ok; ++i) {
      if (c[i] < 0 || c[i] >= n_nodes) ok = false;
      for (int j = i + 1; j < 4 && ok; ++j)
        if (c[i] == c[j]) ok = false;
    }
    if (ok && pos != nullptr) {
      const double* a = pos + 3 * c[0];
      const double* b = pos + 3 * c[1];
      const double* cc = pos + 3 * c[2];
      const double* d = pos + 3 * c[3];
      double u[3], v[3], w[3];
      for (int k = 0; k < 3; ++k) {
        u[k] = b[k] - a[k];
        v[k] = cc[k] - a[k];
        w[k] = d[k] - a[k];
      }
      double vol = u[0] * (v[1] * w[2] - v[2] * w[1]) -
                   u[1] * (v[0] * w[2] - v[2] * w[0]) +
                   u[2] * (v[0] * w[1] - v[1] * w[0]);
      if (vol < 0) vol = -vol;
      if (vol / 6.0 < eps) ok = false;
    }
    if (!ok) ++bad;
  }
  return bad;
}

// ----------------------------------------------------- connected components
// Union-find over cells sharing nodes (disjoint-part extraction,
// reference CuttableMesh::splitParts). out_labels: [n_tets]; returns the
// number of components.
int32_t fem_components(int32_t n_nodes, int32_t n_tets, const int32_t* tets,
                       int32_t* out_labels) {
  std::vector<int32_t> parent(n_tets);
  for (int32_t i = 0; i < n_tets; ++i) parent[i] = i;
  std::function<int32_t(int32_t)> find = [&](int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };
  std::vector<int32_t> owner(n_nodes, -1);
  for (int32_t t = 0; t < n_tets; ++t) {
    for (int i = 0; i < 4; ++i) {
      int32_t n = tets[4 * t + i];
      if (owner[n] < 0) {
        owner[n] = t;
      } else {
        int32_t ra = find(owner[n]), rb = find(t);
        if (ra != rb) parent[ra] = rb;
      }
    }
  }
  std::unordered_map<int32_t, int32_t> remap;
  int32_t n_comp = 0;
  for (int32_t t = 0; t < n_tets; ++t) {
    int32_t r = find(t);
    auto it = remap.find(r);
    if (it == remap.end()) {
      remap.emplace(r, n_comp);
      out_labels[t] = n_comp++;
    } else {
      out_labels[t] = it->second;
    }
  }
  return n_comp;
}

}  // extern "C"
