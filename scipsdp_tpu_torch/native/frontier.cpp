// Native best-first B&B frontier / node pool.
//
// The reference delegates tree management to SCIP's C core (node storage,
// best-bound selection, pruning).  This is the TPU framework's native
// equivalent for the host-side runtime: a slab-allocated node pool with a
// best-bound heap, exposed through a C ABI for ctypes (no pybind11 in this
// environment).  The Python layer keeps per-node side data (cuts,
// warmstart vectors) in a dict keyed by the ids returned here.
//
// Build: g++ -O3 -shared -fPIC -o libfrontier.so frontier.cpp
//
// Semantics match core/branchbound.py's Python heap exactly: pop order is
// (bound, insertion sequence); pruning is lazy (nodes with bound >= cutoff
// are dropped at pop time).

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct HeapEnt {
    double bound;
    int64_t seq;
    int64_t id;
};

struct Cmp {
    bool operator()(const HeapEnt& a, const HeapEnt& b) const {
        if (a.bound != b.bound) return a.bound > b.bound;   // min-heap
        return a.seq > b.seq;
    }
};

struct Frontier {
    int m = 0;                        // variables per node
    int64_t seq = 0;
    std::vector<double> slab;         // 2*m doubles per node (lb ++ ub)
    std::vector<double> bounds;
    std::vector<int32_t> depths;
    std::vector<uint8_t> alive;
    std::vector<int64_t> freelist;    // recycled node slots (allocator)
    std::priority_queue<HeapEnt, std::vector<HeapEnt>, Cmp> heap;
    int64_t nalive = 0;
};

}  // namespace

extern "C" {

void* frontier_create(int m) {
    Frontier* f = new Frontier();
    f->m = m;
    return f;
}

void frontier_destroy(void* h) { delete static_cast<Frontier*>(h); }

int64_t frontier_push(void* h, const double* lb, const double* ub,
                      double bound, int depth) {
    Frontier* f = static_cast<Frontier*>(h);
    int64_t id;
    if (!f->freelist.empty()) {
        id = f->freelist.back();
        f->freelist.pop_back();
        std::memcpy(&f->slab[2 * f->m * id], lb, f->m * sizeof(double));
        std::memcpy(&f->slab[2 * f->m * id + f->m], ub,
                    f->m * sizeof(double));
        f->bounds[id] = bound;
        f->depths[id] = depth;
        f->alive[id] = 1;
    } else {
        id = static_cast<int64_t>(f->bounds.size());
        f->slab.insert(f->slab.end(), lb, lb + f->m);
        f->slab.insert(f->slab.end(), ub, ub + f->m);
        f->bounds.push_back(bound);
        f->depths.push_back(depth);
        f->alive.push_back(1);
    }
    f->heap.push(HeapEnt{bound, f->seq++, id});
    f->nalive++;
    return id;
}

// Pop up to maxn best nodes with bound < cutoff into the out arrays
// (row-major (n, m)); returns the number popped.  Nodes with
// bound >= cutoff are pruned (freed) as encountered.
int frontier_pop_batch(void* h, int maxn, double cutoff, double* out_lb,
                       double* out_ub, double* out_bounds,
                       int32_t* out_depths, int64_t* out_ids) {
    Frontier* f = static_cast<Frontier*>(h);
    int n = 0;
    while (n < maxn && !f->heap.empty()) {
        HeapEnt e = f->heap.top();
        f->heap.pop();
        if (!f->alive[e.id]) continue;    // stale entry
        f->alive[e.id] = 0;
        f->nalive--;
        f->freelist.push_back(e.id);
        if (e.bound >= cutoff) continue;  // late bound pruning
        std::memcpy(out_lb + n * f->m, &f->slab[2 * f->m * e.id],
                    f->m * sizeof(double));
        std::memcpy(out_ub + n * f->m, &f->slab[2 * f->m * e.id + f->m],
                    f->m * sizeof(double));
        out_bounds[n] = e.bound;
        out_depths[n] = f->depths[e.id];
        out_ids[n] = e.id;
        n++;
    }
    return n;
}

int64_t frontier_size(void* h) {
    return static_cast<Frontier*>(h)->nalive;
}

// Best bound among live nodes (skims stale heap entries); +inf if empty.
double frontier_best_bound(void* h) {
    Frontier* f = static_cast<Frontier*>(h);
    while (!f->heap.empty() && !f->alive[f->heap.top().id]) f->heap.pop();
    if (f->heap.empty()) return 1e300;
    return f->heap.top().bound;
}

// Dump all live nodes (for checkpointing); returns count written.
int64_t frontier_dump(void* h, double* out_lb, double* out_ub,
                      double* out_bounds, int32_t* out_depths,
                      int64_t* out_ids) {
    Frontier* f = static_cast<Frontier*>(h);
    int64_t n = 0;
    for (int64_t id = 0; id < static_cast<int64_t>(f->bounds.size()); ++id) {
        if (!f->alive[id]) continue;
        std::memcpy(out_lb + n * f->m, &f->slab[2 * f->m * id],
                    f->m * sizeof(double));
        std::memcpy(out_ub + n * f->m, &f->slab[2 * f->m * id + f->m],
                    f->m * sizeof(double));
        out_bounds[n] = f->bounds[id];
        out_depths[n] = f->depths[id];
        out_ids[n] = id;
        n++;
    }
    return n;
}

}  // extern "C"
