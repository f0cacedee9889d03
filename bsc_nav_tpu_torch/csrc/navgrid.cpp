// Native navigation-grid kernels.
//
// Host-side C++ for the host/device split (SURVEY §2.3): the reference
// leans on habitat-sim's C++ Recast/Detour for pathfinding and runs its
// O(grid^2) frontier scans in Python (reference memory_2.py:1174-1307,
// hot loop #4).  These kernels serve the framework's GridPathfinder and
// frontier explorer on big grids where the Python/scipy paths dominate
// episode setup time.
//
// All functions operate on caller-owned row-major buffers (ctypes).
// Grid convention matches bsc_nav_tpu/env/pathfinding.py: 8-connected,
// diagonal corner-cutting forbidden.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <queue>
#include <vector>
#include <limits>
#include <mutex>
#include <condition_variable>

extern "C" {

static const float kInf = std::numeric_limits<float>::infinity();

struct PQItem {
    float g;
    int idx;
    bool operator>(const PQItem& o) const { return g > o.g; }
};

// Dijkstra distance field over an 8-connected navigability grid.
// nav: [nx*nz] uint8 (1 = navigable); out: [nx*nz] float distances in
// cell units (multiply by resolution on the Python side).
void distance_field(const uint8_t* nav, int nx, int nz,
                    int si, int sj, float* out) {
    const float SQRT2 = std::sqrt(2.0f);
    const int n = nx * nz;
    for (int i = 0; i < n; ++i) out[i] = kInf;
    if (si < 0 || si >= nx || sj < 0 || sj >= nz) return;
    if (!nav[si * nz + sj]) return;

    std::priority_queue<PQItem, std::vector<PQItem>, std::greater<PQItem>> pq;
    out[si * nz + sj] = 0.0f;
    pq.push({0.0f, si * nz + sj});
    const int di[8] = {-1, 1, 0, 0, -1, -1, 1, 1};
    const int dj[8] = {0, 0, -1, 1, -1, 1, -1, 1};
    while (!pq.empty()) {
        PQItem it = pq.top();
        pq.pop();
        if (it.g > out[it.idx]) continue;
        int i = it.idx / nz, j = it.idx % nz;
        for (int k = 0; k < 8; ++k) {
            int ni = i + di[k], nj = j + dj[k];
            if (ni < 0 || ni >= nx || nj < 0 || nj >= nz) continue;
            if (!nav[ni * nz + nj]) continue;
            if (k >= 4) {  // diagonal: forbid corner cutting
                if (!nav[(i + di[k]) * nz + j] || !nav[i * nz + (j + dj[k])])
                    continue;
            }
            float ng = it.g + (k >= 4 ? SQRT2 : 1.0f);
            if (ng < out[ni * nz + nj]) {
                out[ni * nz + nj] = ng;
                pq.push({ng, ni * nz + nj});
            }
        }
    }
}

// A* shortest path.  Returns the number of cells written to out_cells
// (as (i, j) int32 pairs, start..goal), 0 if unreachable, -1 if the
// buffer is too small.
int astar_path(const uint8_t* nav, int nx, int nz,
               int si, int sj, int gi, int gj,
               int32_t* out_cells, int max_cells) {
    const float SQRT2 = std::sqrt(2.0f);
    const int n = nx * nz;
    if (si < 0 || si >= nx || sj < 0 || sj >= nz) return 0;
    if (gi < 0 || gi >= nx || gj < 0 || gj >= nz) return 0;
    if (!nav[si * nz + sj] || !nav[gi * nz + gj]) return 0;

    std::vector<int> came(n, -1);
    auto heur = [&](int i, int j) {
        float dx = float(i - gi), dy = float(j - gj);
        return std::sqrt(dx * dx + dy * dy);
    };
    std::priority_queue<PQItem, std::vector<PQItem>, std::greater<PQItem>> pq;
    pq.push({heur(si, sj), si * nz + sj});
    std::vector<float> gscore(n, kInf);
    gscore[si * nz + sj] = 0.0f;

    const int di[8] = {-1, 1, 0, 0, -1, -1, 1, 1};
    const int dj[8] = {0, 0, -1, 1, -1, 1, -1, 1};
    bool found = false;
    while (!pq.empty()) {
        PQItem it = pq.top();
        pq.pop();
        int i = it.idx / nz, j = it.idx % nz;
        if (i == gi && j == gj) { found = true; break; }
        if (it.g > gscore[it.idx] + heur(i, j) + 1e-6f) continue;
        for (int k = 0; k < 8; ++k) {
            int ni = i + di[k], nj = j + dj[k];
            if (ni < 0 || ni >= nx || nj < 0 || nj >= nz) continue;
            if (!nav[ni * nz + nj]) continue;
            if (k >= 4) {
                if (!nav[(i + di[k]) * nz + j] || !nav[i * nz + (j + dj[k])])
                    continue;
            }
            float ng = gscore[it.idx] + (k >= 4 ? SQRT2 : 1.0f);
            if (ng < gscore[ni * nz + nj]) {
                gscore[ni * nz + nj] = ng;
                came[ni * nz + nj] = it.idx;
                pq.push({ng + heur(ni, nj), ni * nz + nj});
            }
        }
    }
    if (!found) return 0;
    // walk back
    std::vector<int> cells;
    int cur = gi * nz + gj;
    while (cur != -1) {
        cells.push_back(cur);
        if (cur == si * nz + sj) break;
        cur = came[cur];
    }
    int m = int(cells.size());
    if (m > max_cells) return -1;
    for (int k = 0; k < m; ++k) {
        int c = cells[m - 1 - k];
        out_cells[2 * k] = c / nz;
        out_cells[2 * k + 1] = c % nz;
    }
    return m;
}

// Frontier mask: known & navigable cells 4-adjacent to an unknown cell
// (reference memory_2.py:1186-1208).
void find_frontiers(const uint8_t* known, const uint8_t* navigable,
                    int nx, int nz, uint8_t* out) {
    const int di[4] = {-1, 1, 0, 0};
    const int dj[4] = {0, 0, -1, 1};
    for (int i = 0; i < nx; ++i) {
        for (int j = 0; j < nz; ++j) {
            int idx = i * nz + j;
            out[idx] = 0;
            if (!known[idx] || !navigable[idx]) continue;
            for (int k = 0; k < 4; ++k) {
                int ni = i + di[k], nj = j + dj[k];
                if (ni < 0 || ni >= nx || nj < 0 || nj >= nz) continue;
                if (!known[ni * nz + nj]) { out[idx] = 1; break; }
            }
        }
    }
}

// Connected-component labels (BFS).  connectivity: 4 or 8.
// labels: int32 out, -1 for background.  Returns component count.
int label_components(const uint8_t* mask, int nx, int nz,
                     int connectivity, int32_t* labels) {
    const int n = nx * nz;
    for (int i = 0; i < n; ++i) labels[i] = -1;
    const int di8[8] = {-1, 1, 0, 0, -1, -1, 1, 1};
    const int dj8[8] = {0, 0, -1, 1, -1, 1, -1, 1};
    int ndirs = (connectivity == 8) ? 8 : 4;
    int next = 0;
    std::vector<int> stack;
    for (int s = 0; s < n; ++s) {
        if (!mask[s] || labels[s] != -1) continue;
        stack.push_back(s);
        labels[s] = next;
        while (!stack.empty()) {
            int cur = stack.back();
            stack.pop_back();
            int i = cur / nz, j = cur % nz;
            for (int k = 0; k < ndirs; ++k) {
                int ni = i + di8[k], nj = j + dj8[k];
                if (ni < 0 || ni >= nx || nj < 0 || nj >= nz) continue;
                int nidx = ni * nz + nj;
                if (mask[nidx] && labels[nidx] == -1) {
                    labels[nidx] = next;
                    stack.push_back(nidx);
                }
            }
        }
        ++next;
    }
    return next;
}

// ---------------------------------------------------------------------
// Frame staging ring buffer: producer (env stepping thread) pushes
// RGB-D frames + poses; consumer pops packed contiguous batches for
// device transfer (the obs-ingest boundary, SURVEY §2.3 row 1).
// ---------------------------------------------------------------------

struct FrameQueue {
    int capacity, h, w;
    size_t rgb_sz, depth_sz;
    std::vector<uint8_t> rgb;
    std::vector<float> depth;
    std::vector<float> poses;
    int head = 0, count = 0;
    std::mutex mu;
};

void* fq_create(int capacity, int h, int w) {
    FrameQueue* q = new FrameQueue();
    q->capacity = capacity;
    q->h = h;
    q->w = w;
    q->rgb_sz = size_t(h) * w * 3;
    q->depth_sz = size_t(h) * w;
    q->rgb.resize(q->rgb_sz * capacity);
    q->depth.resize(q->depth_sz * capacity);
    q->poses.resize(size_t(7) * capacity);
    return q;
}

void fq_destroy(void* qp) { delete static_cast<FrameQueue*>(qp); }

int fq_size(void* qp) {
    FrameQueue* q = static_cast<FrameQueue*>(qp);
    std::lock_guard<std::mutex> lk(q->mu);
    return q->count;
}

// Returns 1 on success, 0 when full.
int fq_push(void* qp, const uint8_t* rgb, const float* depth,
            const float* pose) {
    FrameQueue* q = static_cast<FrameQueue*>(qp);
    std::lock_guard<std::mutex> lk(q->mu);
    if (q->count >= q->capacity) return 0;
    int slot = (q->head + q->count) % q->capacity;
    std::memcpy(&q->rgb[q->rgb_sz * slot], rgb, q->rgb_sz);
    std::memcpy(&q->depth[q->depth_sz * slot], depth,
                q->depth_sz * sizeof(float));
    std::memcpy(&q->poses[7 * slot], pose, 7 * sizeof(float));
    q->count++;
    return 1;
}

// Pops up to n frames into packed batch buffers; returns count popped.
int fq_pop_batch(void* qp, int n, uint8_t* rgb_out, float* depth_out,
                 float* poses_out) {
    FrameQueue* q = static_cast<FrameQueue*>(qp);
    std::lock_guard<std::mutex> lk(q->mu);
    int m = n < q->count ? n : q->count;
    for (int k = 0; k < m; ++k) {
        int slot = (q->head + k) % q->capacity;
        std::memcpy(rgb_out + q->rgb_sz * k, &q->rgb[q->rgb_sz * slot],
                    q->rgb_sz);
        std::memcpy(depth_out + q->depth_sz * k,
                    &q->depth[q->depth_sz * slot],
                    q->depth_sz * sizeof(float));
        std::memcpy(poses_out + 7 * k, &q->poses[7 * slot],
                    7 * sizeof(float));
    }
    q->head = (q->head + m) % q->capacity;
    q->count -= m;
    return m;
}

}  // extern "C"
