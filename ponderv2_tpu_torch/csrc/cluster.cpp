// Radius-graph connected-component clustering (PointGroup proposal generation).
//
// Native equivalent of the reference's pointgroup_ops CUDA ballquery + C++ BFS
// (reference libs/pointgroup_ops/src/bfs_cluster.cpp:40-145): two points
// connect iff within `radius` (strict) AND sharing a semantic class. Uses a
// uniform grid hash (cell = radius) to build index-ordered neighbor lists
// (capped at the reference kernel's 1000), then the reference's exact BFS.
//
// Build: ponderv2_tpu/csrc/build.sh  ->  libponder_cluster.so (ctypes ABI).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

inline int64_t cell_key(int64_t cx, int64_t cy, int64_t cz) {
  // large-prime mix; exactness not required (collisions only add candidates)
  return cx * 73856093LL ^ cy * 19349663LL ^ cz * 83492791LL;
}

}  // namespace

extern "C" {

// coords: (n, 3) float32; classes: (n,) int32; out_ids: (n,) int32 (-1 = noise).
// Returns the number of clusters with >= min_points members.
int32_t ponder_bfs_cluster(const float* coords, const int32_t* classes,
                           int32_t n, float radius, int32_t min_points,
                           int32_t* out_ids) {
  if (n <= 0) return 0;
  const float r2 = radius * radius;
  const float inv_cell = 1.0f / radius;

  std::unordered_map<int64_t, std::vector<int32_t>> grid;
  grid.reserve(static_cast<size_t>(n) * 2);
  std::vector<int64_t> cx(n), cy(n), cz(n);
  for (int32_t i = 0; i < n; ++i) {
    cx[i] = static_cast<int64_t>(std::floor(coords[3 * i + 0] * inv_cell));
    cy[i] = static_cast<int64_t>(std::floor(coords[3 * i + 1] * inv_cell));
    cz[i] = static_cast<int64_t>(std::floor(coords[3 * i + 2] * inv_cell));
    grid[cell_key(cx[i], cy[i], cz[i])].push_back(i);
  }

  // Per-point neighbor lists in ASCENDING INDEX ORDER, truncated at the
  // reference kernel's hard cap of 1000 (bfs_cluster_kernel.cu idx_temp[1000];
  // the kernel scans refs in index order and breaks past the cap). Neighbors
  // include self (d2 = 0 < r2) and use a STRICT d2 < r2 test.
  constexpr int32_t kNeighborCap = 1000;
  std::vector<std::vector<int32_t>> nbr(n);
  std::vector<int32_t> cand;
  for (int32_t i = 0; i < n; ++i) {
    const float xi = coords[3 * i], yi = coords[3 * i + 1], zi = coords[3 * i + 2];
    cand.clear();
    for (int64_t dx = -1; dx <= 1; ++dx)
      for (int64_t dy = -1; dy <= 1; ++dy)
        for (int64_t dz = -1; dz <= 1; ++dz) {
          auto it = grid.find(cell_key(cx[i] + dx, cy[i] + dy, cz[i] + dz));
          if (it == grid.end()) continue;
          for (int32_t j : it->second) {
            const float ddx = coords[3 * j] - xi;
            const float ddy = coords[3 * j + 1] - yi;
            const float ddz = coords[3 * j + 2] - zi;
            if (ddx * ddx + ddy * ddy + ddz * ddz < r2) cand.push_back(j);
          }
        }
    std::sort(cand.begin(), cand.end());
    if ((int32_t)cand.size() > kNeighborCap) cand.resize(kNeighborCap);
    nbr[i] = cand;
  }

  // Reference BFS (bfs_cluster.cpp:53-100): seed each unvisited point in
  // ascending order; expand through neighbors sharing the CURRENT point's
  // label; components below min_points are discarded but stay visited.
  std::vector<int32_t> visited(n, 0);
  std::vector<int32_t> queue, members;
  int32_t next_id = 0;
  for (int32_t i = 0; i < n; ++i) {
    if (visited[i]) continue;
    members.clear();
    queue.clear();
    visited[i] = 1;
    members.push_back(i);
    queue.push_back(i);
    size_t head = 0;
    while (head < queue.size()) {
      const int32_t cur = queue[head++];
      const int32_t label_cur = classes[cur];
      for (int32_t j : nbr[cur]) {
        if (visited[j] || classes[j] != label_cur) continue;
        visited[j] = 1;
        members.push_back(j);
        queue.push_back(j);
      }
    }
    if ((int32_t)members.size() >= min_points) {
      for (int32_t j : members) out_ids[j] = next_id;
      ++next_id;
    } else {
      for (int32_t j : members) out_ids[j] = -1;
    }
  }
  return next_id;
}

// Fixed-radius neighbor query with CSR output sizing pass
// (native analog of pointgroup_ops ballquery_batch_p, functions.py:6-44).
// Writes up to max_neighbors per query into out_idx; out_cnt gets true counts.
void ponder_ball_query(const float* coords, int32_t n, const float* queries,
                       int32_t m, float radius, int32_t max_neighbors,
                       int32_t* out_idx, int32_t* out_cnt) {
  const float r2 = radius * radius;
  const float inv_cell = 1.0f / radius;
  std::unordered_map<int64_t, std::vector<int32_t>> grid;
  grid.reserve(static_cast<size_t>(n) * 2);
  for (int32_t i = 0; i < n; ++i) {
    const int64_t gx = static_cast<int64_t>(std::floor(coords[3 * i] * inv_cell));
    const int64_t gy = static_cast<int64_t>(std::floor(coords[3 * i + 1] * inv_cell));
    const int64_t gz = static_cast<int64_t>(std::floor(coords[3 * i + 2] * inv_cell));
    grid[cell_key(gx, gy, gz)].push_back(i);
  }
  for (int32_t q = 0; q < m; ++q) {
    const float xq = queries[3 * q], yq = queries[3 * q + 1], zq = queries[3 * q + 2];
    const int64_t gx = static_cast<int64_t>(std::floor(xq * inv_cell));
    const int64_t gy = static_cast<int64_t>(std::floor(yq * inv_cell));
    const int64_t gz = static_cast<int64_t>(std::floor(zq * inv_cell));
    int32_t cnt = 0;
    for (int64_t dx = -1; dx <= 1 && cnt < max_neighbors; ++dx)
      for (int64_t dy = -1; dy <= 1 && cnt < max_neighbors; ++dy)
        for (int64_t dz = -1; dz <= 1 && cnt < max_neighbors; ++dz) {
          auto it = grid.find(cell_key(gx + dx, gy + dy, gz + dz));
          if (it == grid.end()) continue;
          for (int32_t j : it->second) {
            const float ddx = coords[3 * j] - xq;
            const float ddy = coords[3 * j + 1] - yq;
            const float ddz = coords[3 * j + 2] - zq;
            if (ddx * ddx + ddy * ddy + ddz * ddz <= r2) {
              if (cnt < max_neighbors) out_idx[q * max_neighbors + cnt] = j;
              ++cnt;
            }
          }
        }
    out_cnt[q] = cnt;
  }
}

}  // extern "C"
