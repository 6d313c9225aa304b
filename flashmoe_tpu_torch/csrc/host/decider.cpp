// flashmoe_tpu_torch's native Decider: topology-aware DP x EP group
// formation and rate-proportional expert assignment (the port's own copy
// of the JAX package's decider, the same C API and the same results).
//
// Greedy hierarchical merging over an alpha-beta adjacency matrix with a
// compute + comm + all-reduce objective, memory feasibility forcing, and
// rate-proportional expert counts within each group.  The Python
// implementation (flashmoe_tpu_torch/parallel/decider.py) is the
// reference; tests/test_torch_decider.py holds the two equal.
//
// Built with g++ at first use by flashmoe_tpu_torch/runtime/_native.py
// (into the same library as the token loader) and bound with ctypes there.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <numeric>
#include <queue>
#include <vector>

namespace {

struct DSU {
  std::vector<int> parent;
  explicit DSU(int n) : parent(n) { std::iota(parent.begin(), parent.end(), 0); }
  int find(int x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];  // path halving
      x = parent[x];
    }
    return x;
  }
  int unite(int a, int b) {
    int ra = find(a), rb = find(b);
    if (ra != rb) parent[rb] = ra;
    return ra;
  }
};

struct Ctx {
  int n;
  const double* alpha;
  const double* beta;
  const double* rate;
  const double* mem_gb;
  int num_experts;
  double expert_mb, act_mb, grad_mb, gamma;
  bool training;

  double transfer_ms(int i, int j, double mb) const {
    return alpha[i * n + j] + beta[i * n + j] * mb;
  }
  bool can_hold_all(const std::vector<int>& mem) const {
    double cap = 0;
    for (int d : mem) cap += mem_gb[d] * 1024.0;
    return cap >= num_experts * expert_mb;
  }
  // worst pairwise transfer, payload split across the group (the
  // reference's evalP2PTime with p2pBuffer/numNodes)
  double intra_comm_ms(const std::vector<int>& mem) const {
    double worst = 0;
    double mb = act_mb / std::max<size_t>(mem.size(), 1);
    for (int i : mem)
      for (int j : mem)
        if (i != j) worst = std::max(worst, transfer_ms(i, j, mb));
    return worst;
  }
  // memory-infeasible groups price at infinity (the reference's
  // must-merge encoding, functions.cuh obj())
  double objective(const std::vector<int>& mem, double ar_ms) const {
    if (!can_hold_all(mem)) return std::numeric_limits<double>::infinity();
    double r = 0;
    for (int d : mem) r += rate[d];
    double total_cost =
        num_experts / std::max(*std::min_element(rate, rate + n), 1e-9);
    double compute = total_cost / std::max(r, 1e-9);
    return gamma * (compute + 1.0 * intra_comm_ms(mem)) + ar_ms;
  }
};

}  // namespace

extern "C" {

// Returns 0 on success.  group_id_out[d] = group index of device d
// (dense, ordered by smallest member).  expert_counts_out[d] = number of
// experts assigned to device d within its group.
int flashmoe_decide(int n, const double* alpha, const double* beta,
                    const double* throughput, const double* memory_gb,
                    int num_experts, double expert_mb, double act_mb,
                    double grad_mb, double gamma, int is_training,
                    int* group_id_out, int* expert_counts_out) {
  if (n <= 0 || num_experts <= 0) return 1;
  Ctx ctx{n,        alpha,    beta,    throughput, memory_gb, num_experts,
          expert_mb, act_mb,  grad_mb, gamma,      is_training != 0};

  DSU dsu(n);
  std::vector<std::vector<int>> members(n);
  for (int d = 0; d < n; ++d) members[d] = {d};
  auto alive = [&](int r) { return !members[r].empty(); };
  auto num_groups = [&]() {
    int g = 0;
    for (int d = 0; d < n; ++d)
      if (dsu.find(d) == d) ++g;
    return g;
  };

  struct Edge {
    double w; int a, b;
    bool operator<(const Edge& o) const { return w < o.w; }  // PQ: max by w
  };
  std::vector<Edge> edges;
  edges.reserve(n * (n - 1) / 2);
  for (int i = 0; i < n; ++i)
    for (int j = i + 1; j < n; ++j)
      edges.push_back({ctx.transfer_ms(i, j, act_mb), i, j});
  std::stable_sort(edges.begin(), edges.end(),
                   [](const Edge& x, const Edge& y) { return x.w < y.w; });

  // inter-group allreduce bottleneck: max-heap of external edges keyed by
  // per-chunk gradient transfer time, maintained across merges exactly as
  // the reference's externalEdges priority queue (decider.cuh:60,86-158).
  // Inference jobs (training == false) skip the term entirely — the
  // reference's Decider<JobType::inference> specialization.
  const bool use_ar = ctx.training && ctx.grad_mb > 0;
  std::priority_queue<Edge> ext;  // Edge::operator< orders by w: max-heap
  if (use_ar)
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j)
        if (i != j) ext.push({ctx.transfer_ms(i, j, ctx.grad_mb / n), i, j});

  for (const Edge& e : edges) {
    int ra = dsu.find(e.a), rb = dsu.find(e.b);
    if (ra == rb) continue;
    auto& ga = members[ra];
    auto& gb = members[rb];
    std::vector<int> merged = ga;
    merged.insert(merged.end(), gb.begin(), gb.end());
    double ar_parts = 0.0, ar_merged = 0.0;
    std::vector<Edge> limbo;  // edges the merge would internalize
    if (use_ar) {
      while (!ext.empty()) {
        Edge t = ext.top();
        int fa = dsu.find(t.a), fb = dsu.find(t.b);
        if (fa == fb) { ext.pop(); continue; }      // intra forever
        if ((fa == ra && fb == rb) || (fa == rb && fb == ra)) {
          limbo.push_back(t);                        // internal iff merged
          ext.pop();
          continue;
        }
        break;
      }
      // Heap ORDER stays keyed at the initial chunk grad_mb/n; the VALUE
      // is repriced with the chunk of the live partition (grad_mb/g now,
      // grad_mb/(g-1) post-merge) — the reference's ARArgs::refresh
      // (args.cuh:37, decider.cuh:96-158).
      int g = num_groups();
      double cur_bot = 0.0;
      if (!ext.empty())
        cur_bot = ctx.transfer_ms(ext.top().a, ext.top().b, ctx.grad_mb / g);
      for (const Edge& l : limbo)
        cur_bot = std::max(cur_bot,
                           ctx.transfer_ms(l.a, l.b, ctx.grad_mb / g));
      ar_parts = g > 1 ? 2.0 * (g - 1) * cur_bot : 0.0;
      ar_merged = (g - 1 > 1 && !ext.empty())
                      ? 2.0 * (g - 2) *
                            ctx.transfer_ms(ext.top().a, ext.top().b,
                                            ctx.grad_mb / (g - 1))
                      : 0.0;
    }
    double o1 = ctx.objective(ga, ar_parts);
    double o2 = ctx.objective(gb, ar_parts);
    double om = ctx.objective(merged, ar_merged);
    bool both_inf = std::isinf(o1) && std::isinf(o2);
    if (both_inf || om <= std::max(o1, o2)) {
      int root = dsu.unite(ra, rb);
      int other = (root == ra) ? rb : ra;
      members[root] = merged;
      members[other].clear();
      // limbo edges became intra-group: stay out of the pool
    } else {
      for (const Edge& l : limbo) ext.push(l);
    }
  }

  // infeasible groups merge into the nearest feasible neighbour until done
  bool changed = true;
  while (changed) {
    changed = false;
    int roots = 0;
    for (int d = 0; d < n; ++d)
      if (alive(d)) ++roots;
    if (roots <= 1) break;
    for (int r = 0; r < n && !changed; ++r) {
      if (!alive(r) || ctx.can_hold_all(members[r])) continue;
      int best = -1;
      double bestc = 1e300;
      for (int r2 = 0; r2 < n; ++r2) {
        if (r2 == r || !alive(r2)) continue;
        for (int x : members[r]) {
          for (int y : members[r2]) {
            double c = ctx.transfer_ms(x, y, act_mb);
            if (c < bestc) { bestc = c; best = r2; }
          }
        }
      }
      if (best >= 0) {
        std::vector<int> merged = members[r];
        merged.insert(merged.end(), members[best].begin(),
                      members[best].end());
        int root = dsu.unite(r, best);
        int other = (root == r) ? best : r;
        members[root] = merged;
        members[other].clear();
        changed = true;
      }
    }
  }

  // dense group ids ordered by smallest member
  std::vector<std::pair<int, int>> order;  // (min member, root)
  for (int d = 0; d < n; ++d)
    if (alive(d))
      order.push_back({*std::min_element(members[d].begin(), members[d].end()),
                       d});
  std::sort(order.begin(), order.end());
  for (size_t g = 0; g < order.size(); ++g)
    for (int d : members[order[g].second]) group_id_out[d] = (int)g;

  // rate-proportional expert assignment within each group
  for (int d = 0; d < n; ++d) expert_counts_out[d] = 0;
  for (auto& [mn, root] : order) {
    auto group = members[root];
    std::sort(group.begin(), group.end());
    double rsum = 0;
    for (int d : group) rsum += throughput[d];
    std::vector<int> budget(group.size());
    int assigned = 0;
    for (size_t i = 0; i < group.size(); ++i) {
      budget[i] = (int)std::floor(num_experts * throughput[group[i]] / rsum);
      assigned += budget[i];
    }
    // remainder to fastest devices
    std::vector<size_t> idx(group.size());
    std::iota(idx.begin(), idx.end(), 0);
    std::stable_sort(idx.begin(), idx.end(), [&](size_t a, size_t b) {
      return throughput[group[a]] > throughput[group[b]];
    });
    for (int k = 0; k < num_experts - assigned; ++k)
      budget[idx[k % group.size()]] += 1;
    for (size_t i = 0; i < group.size(); ++i)
      expert_counts_out[group[i]] = budget[i];
  }
  return 0;
}

// Library version for the ctypes loader's handshake.
int flashmoe_native_abi_version() { return 1; }

}  // extern "C"
