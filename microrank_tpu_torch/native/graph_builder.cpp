// Native window-graph builder: interned span rows -> COO partition graphs.
//
// The graph-build stage of the framework (reference: get_pagerank_graph
// preprocess_data.py:146-171 plus the matrix fills of pagerank.py:35-52 and
// the kind dedup of pagerank.py:54-66). The numpy lane
// (graph/build.py:_build_partition) is O(n log n) via comparison sorts;
// every id here is a bounded small int (op vocab, window-local trace ids),
// so this builds both partitions in fused single scans: one stats pass
// over the rows for BOTH partitions, a bucket-scatter by trace, small
// in-cache per-trace sorts for the unique-op rows, and one counting sort
// for the call edges — O(n + V + T) total.
//
// Two-phase API: mr_build_window2 computes everything and returns an
// opaque handle; mr_window_sizes reports array lengths; mr_export_partition
// copies each partition once, directly into caller-allocated (padded)
// numpy buffers — no intermediate heap copies on either side.
//
// Output order is kept identical to the numpy lane (incidence sorted by
// (local trace asc, op asc), call edges by (child asc, parent asc), local
// trace ids assigned in ascending global-id order) so the two lanes are
// array-for-array interchangeable.

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <mutex>
#include <new>
#include <optional>
#include <system_error>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// Splitmix64 finalizer (same mixer family as graph/build.py:_splitmix64).
// Only a prefilter here — kind equality is decided by exact compare.
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// MR_BUILD_PROFILE=1 prints per-phase wall times to stderr — the
// profiling hook behind DESIGN.md's build-cost numbers.
bool profile_enabled() {
  static const bool on = [] {
    const char* env = std::getenv("MR_BUILD_PROFILE");
    return env && env[0] == '1';
  }();
  return on;
}

struct PhaseTimer {
  const char* name;
  std::chrono::steady_clock::time_point start;
  explicit PhaseTimer(const char* n)
      : name(n), start(std::chrono::steady_clock::now()) {}
  ~PhaseTimer() {
    if (profile_enabled()) {
      const double ms =
          std::chrono::duration<double, std::milli>(
              std::chrono::steady_clock::now() - start)
              .count();
      std::fprintf(stderr, "[mr_build] %-12s %8.2f ms\n", name, ms);
    }
  }
};

struct BuiltPartition {
  std::vector<int32_t> inc_op, inc_trace;
  std::vector<float> sr_val, rs_val;
  std::vector<int32_t> ss_child, ss_parent;
  std::vector<float> ss_val;
  std::vector<int32_t> kind, tracelen, local_uniques;
  std::vector<int32_t> cov_unique;
  std::vector<uint8_t> op_present;
  int64_t n_ops = 0;
  // Kind grouping (analyze_partition's kinds phase): group id per trace,
  // size per group. Group ids are assigned in first-encounter order over
  // ascending trace ids, so they double as the collapsed column order.
  std::vector<int32_t> group_of;
  std::vector<int32_t> group_count;
  int64_t n_groups = 0;
  // Collapsed emit (emit_partition(collapse=true)): the TRUE trace
  // count — kind/tracelen then hold one entry per kind column
  // (mr_collapse_window reports it). -1 = per-trace layout.
  int64_t n_traces_true = -1;
};

}  // namespace

extern "C" {

// Opaque to callers; errors are signaled by a null handle from
// mr_build_window2 (allocation failure).
struct MrBuiltWindow {
  BuiltPartition parts[2];  // [0]=normal, [1]=abnormal
};

}  // extern "C"

namespace {

// Above this vocab size the per-partition edge bitmap (vocab^2 bits)
// would exceed 32 MB; fall back to the instance-list counting sorts.
// MR_EDGE_BITMAP_MAX_VOCAB overrides (tests force the fallback with 0).
int64_t edge_bitmap_max_vocab() {
  // Re-read per build (a handful of getenv calls) so tests can toggle
  // the fallback without a fresh process.
  if (const char* env = std::getenv("MR_EDGE_BITMAP_MAX_VOCAB"))
    return static_cast<int64_t>(std::atoll(env));
  return 16384;
}

// Scratch accumulated for one partition during the fused scans.
struct PartScratch {
  std::vector<int32_t> counts_global;  // [n_total_traces] span counts
  std::vector<int32_t> cov_dup;        // [vocab]
  std::vector<int32_t> outdeg_dup;     // [vocab]
  // Unique call edges, deduplicated AT SCAN TIME: bit key
  // child*vocab+parent in a child-major bitmap, so the ordered word
  // scan in finish_partition emits (child asc, parent asc) directly —
  // no instance lists, no counting sorts. Empty when vocab is past the
  // bitmap budget; the legacy instance lists below are used instead.
  std::vector<uint64_t> edge_bits;
  std::vector<int32_t> edge_child;     // call-edge instances (fallback)
  std::vector<int32_t> edge_parent;
  std::vector<int32_t> local_id;       // [n_total_traces] global -> local
  std::vector<int64_t> tr_off;         // [n_traces+1] bucket offsets
  std::vector<int32_t> by_trace_op;    // [n_p] ops bucketed by local trace
  int64_t n_p = 0;
  // analyze_partition outputs consumed by emit_partition: unique-op
  // count + set hash per trace, and the unique-entry prefix offsets.
  std::vector<int32_t> n_uniq;
  std::vector<uint64_t> trace_hash;
  std::vector<int64_t> u_start;
};

// Worker count for the intra-partition trace chunks: the hardware
// concurrency (this scales the 4M-span build on real multi-core TPU
// hosts; a 1-core container just runs the serial path), overridable via
// MR_BUILD_THREADS for testing the chunked code on any box.
int build_threads() {
  // Re-read per call so tests can exercise the chunked path without a
  // fresh process; the cost is a few getenv calls per window build.
  if (const char* env = std::getenv("MR_BUILD_THREADS")) {
    const long v = std::atol(env);
    if (v >= 1 && v <= 64) return static_cast<int>(v);
  }
  const unsigned hw = std::thread::hardware_concurrency();
  return static_cast<int>(std::max(1u, std::min(hw, 16u)));
}

// Run fn(lo, hi) over [0, n) split into k contiguous chunks with
// boundaries chosen so each chunk covers ~equal WEIGHT (weights given by
// the monotone prefix array `prefix` of length n+1). k==1 short-circuits
// to a plain call; the first worker exception is rethrown on the caller.
template <typename Fn>
void parallel_chunks(int64_t n, const int64_t* prefix, int k, Fn fn) {
  if (n <= 0) return;
  if (k <= 1 || n < 2 * k) {
    fn(static_cast<int64_t>(0), n);
    return;
  }
  const int64_t total = prefix[n];
  std::vector<int64_t> bounds(k + 1, 0);
  bounds[k] = n;
  for (int i = 1; i < k; ++i) {
    const int64_t target = total * i / k;
    // first index whose prefix exceeds target
    const int64_t* it = std::upper_bound(prefix, prefix + n + 1, target);
    bounds[i] = std::min<int64_t>(it - prefix - 1, n);
  }
  for (int i = 1; i <= k; ++i) bounds[i] = std::max(bounds[i], bounds[i - 1]);
  std::vector<std::thread> pool;
  std::mutex err_mu;
  std::exception_ptr first_err;
  auto record = [&](std::exception_ptr e) {
    std::lock_guard<std::mutex> lk(err_mu);
    if (!first_err) first_err = e;
  };
  pool.reserve(k - 1);
  try {
    for (int i = 1; i < k; ++i) {
      pool.emplace_back([&, i] {
        try {
          fn(bounds[i], bounds[i + 1]);
        } catch (...) {
          record(std::current_exception());
        }
      });
    }
  } catch (...) {
    // Thread creation failed mid-loop (EAGAIN under resource
    // exhaustion). Joinable threads in `pool` would std::terminate in
    // the vector destructor during unwind — join them first, then let
    // the caller's system_error fallback engage.
    record(std::current_exception());
  }
  try {
    fn(bounds[0], bounds[1]);
  } catch (...) {
    record(std::current_exception());
  }
  for (auto& th : pool) th.join();
  if (first_err) std::rethrow_exception(first_err);
}

void analyze_partition(PartScratch& sc, int64_t vocab, BuiltPartition* out) {
  const int64_t n_traces = static_cast<int64_t>(out->local_uniques.size());
  auto& tracelen = out->tracelen;
  const std::vector<int64_t>& tr_off = sc.tr_off;
  std::vector<int32_t>& by_trace_op = sc.by_trace_op;

  // Pass 1 — per-trace sort + IN-PLACE dedup + kind hash. Buckets are
  // disjoint, so trace chunks run on the thread pool (chunk boundaries
  // balanced by span counts via tr_off; the per-trace sorts are the
  // single-core hot spot at the 4M-span scale).
  auto& n_uniq = sc.n_uniq;
  auto& trace_hash = sc.trace_hash;
  n_uniq.assign(n_traces, 0);
  trace_hash.assign(n_traces, 0);
  // RAII phase scopes: .emplace() prints the previous phase (destructor)
  // and starts the next; unwinding destroys the active one.
  std::optional<PhaseTimer> tm;
  if (profile_enabled()) tm.emplace("sort+dedup");
  parallel_chunks(
      n_traces, tr_off.data(), build_threads(),
      [&](int64_t t0, int64_t t1) {
        for (int64_t t = t0; t < t1; ++t) {
          int32_t* b = by_trace_op.data() + tr_off[t];
          int32_t* e = by_trace_op.data() + tr_off[t + 1];
          std::sort(b, e);
          int32_t* w = b;
          int32_t prev = -1;
          uint64_t h = 0;
          for (int32_t* p = b; p < e; ++p) {
            if (*p == prev) continue;
            prev = *p;
            *w++ = *p;
            h += splitmix64(static_cast<uint64_t>(*p));
          }
          const int64_t uq = w - b;
          n_uniq[t] = static_cast<int32_t>(uq);
          trace_hash[t] =
              h ^ splitmix64(static_cast<uint64_t>(tracelen[t])) ^
              splitmix64(static_cast<uint64_t>(uq) + 0x51ED270B9ULL);
        }
      });

  if (profile_enabled()) tm.emplace("cov+kinds");

  // Unique-coverage histogram straight from the deduped buckets (the
  // emit may be collapsed, so the per-trace entries can't be counted
  // from the output arrays).
  auto& u_start = sc.u_start;
  u_start.assign(n_traces + 1, 0);
  for (int64_t t = 0; t < n_traces; ++t)
    u_start[t + 1] = u_start[t] + n_uniq[t];
  out->cov_unique.assign(vocab, 0);
  auto& cov_unique = out->cov_unique;
  for (int64_t t = 0; t < n_traces; ++t) {
    const int32_t* b = by_trace_op.data() + tr_off[t];
    for (int32_t j = 0; j < n_uniq[t]; ++j) ++cov_unique[b[j]];
  }
  out->op_present.assign(vocab, 0);
  for (int64_t o = 0; o < vocab; ++o)
    if (cov_unique[o] > 0) {
      out->op_present[o] = 1;
      ++out->n_ops;
    }

  // Trace kinds: two traces are one kind iff identical unique-op
  // sequence AND identical span count (== p_sr-column equality,
  // pagerank.py:54-66). Hash prefilter + exact bucket compare on
  // collision — always exact. Group ids in first-encounter order.
  {
    std::unordered_map<uint64_t, std::vector<int32_t>> groups;
    auto& group_of = out->group_of;
    auto& group_count = out->group_count;
    group_of.assign(n_traces, -1);
    group_count.clear();
    groups.reserve(static_cast<size_t>(n_traces) * 2);
    for (int64_t t = 0; t < n_traces; ++t) {
      auto& reps = groups[trace_hash[t]];
      int32_t g = -1;
      for (int32_t rep : reps) {
        if (n_uniq[rep] != n_uniq[t] || tracelen[rep] != tracelen[t])
          continue;
        if (std::memcmp(by_trace_op.data() + tr_off[rep],
                        by_trace_op.data() + tr_off[t],
                        static_cast<size_t>(n_uniq[t]) *
                            sizeof(int32_t)) == 0) {
          g = group_of[rep];
          break;
        }
      }
      if (g < 0) {
        g = static_cast<int32_t>(group_count.size());
        group_count.push_back(0);
        reps.push_back(static_cast<int32_t>(t));
      }
      group_of[t] = g;
      ++group_count[g];
    }
    out->n_groups = static_cast<int64_t>(group_count.size());
  }
}

void emit_partition(PartScratch& sc, BuiltPartition* out, bool collapse) {
  const int64_t n_traces = static_cast<int64_t>(out->local_uniques.size());
  const std::vector<int64_t>& tr_off = sc.tr_off;
  const std::vector<int32_t>& by_trace_op = sc.by_trace_op;
  const std::vector<int32_t>& n_uniq = sc.n_uniq;
  const std::vector<int64_t>& u_start = sc.u_start;
  auto& tracelen = out->tracelen;
  auto& inc_op = out->inc_op;
  auto& inc_trace = out->inc_trace;
  auto& sr_val = out->sr_val;
  auto& rs_val = out->rs_val;
  std::optional<PhaseTimer> tm;
  if (profile_enabled()) tm.emplace(collapse ? "emit-collapsed" : "emit");

  if (collapse) {
    // Emit ONE column per kind group, multiplicity folded into the
    // forward value (m/len in double, cast once — the numpy lane's
    // exact arithmetic). The 1M-entry per-trace emit never happens.
    const int64_t n_groups = out->n_groups;
    std::vector<int32_t> rep(n_groups, -1);
    for (int64_t t = 0; t < n_traces; ++t)
      if (rep[out->group_of[t]] < 0)
        rep[out->group_of[t]] = static_cast<int32_t>(t);
    int64_t n_inc = 0;
    for (int64_t g = 0; g < n_groups; ++g) n_inc += n_uniq[rep[g]];
    inc_op.resize(n_inc);
    inc_trace.resize(n_inc);
    sr_val.resize(n_inc);
    rs_val.resize(n_inc);
    std::vector<int32_t> new_kind(n_groups), new_len(n_groups);
    int64_t w = 0;
    for (int64_t g = 0; g < n_groups; ++g) {
      const int32_t r = rep[g];
      const float sr = static_cast<float>(
          static_cast<double>(out->group_count[g]) /
          static_cast<double>(tracelen[r]));
      const int32_t* b = by_trace_op.data() + tr_off[r];
      for (int32_t j = 0; j < n_uniq[r]; ++j, ++w) {
        const int32_t op = b[j];
        inc_op[w] = op;
        inc_trace[w] = static_cast<int32_t>(g);
        sr_val[w] = sr;
        rs_val[w] = 1.0f / static_cast<float>(sc.cov_dup[op]);
      }
      new_kind[g] = out->group_count[g];
      new_len[g] = tracelen[r];
    }
    out->kind.swap(new_kind);
    tracelen.swap(new_len);
    out->n_traces_true = n_traces;
    return;
  }

  const int64_t n_inc = u_start[n_traces];
  inc_op.resize(n_inc);
  inc_trace.resize(n_inc);
  sr_val.resize(n_inc);
  rs_val.resize(n_inc);
  parallel_chunks(
      n_traces, u_start.data(), build_threads(),
      [&](int64_t t0, int64_t t1) {
        for (int64_t t = t0; t < t1; ++t) {
          const int32_t* b = by_trace_op.data() + tr_off[t];
          const float inv_len = 1.0f / static_cast<float>(tracelen[t]);
          int64_t w = u_start[t];
          for (int32_t j = 0; j < n_uniq[t]; ++j, ++w) {
            const int32_t op = b[j];
            inc_op[w] = op;
            inc_trace[w] = static_cast<int32_t>(t);
            sr_val[w] = inv_len;
            rs_val[w] = 1.0f / static_cast<float>(sc.cov_dup[op]);
          }
        }
      });
  out->kind.assign(n_traces, 0);
  for (int64_t t = 0; t < n_traces; ++t)
    out->kind[t] = out->group_count[out->group_of[t]];
}

void edges_partition(PartScratch& sc, int64_t vocab, BuiltPartition* out) {
  std::optional<PhaseTimer> tm;
  if (profile_enabled()) tm.emplace("edges");

  if (!sc.edge_bits.empty()) {
    // Edges were deduplicated at scan time into the child-major bitmap;
    // an ascending word/bit scan IS (child asc, parent asc) order —
    // matching the numpy lane's packed-key np.unique.
    const int64_t n_words = static_cast<int64_t>(sc.edge_bits.size());
    for (int64_t w = 0; w < n_words; ++w) {
      uint64_t bits = sc.edge_bits[w];
      while (bits) {
        const int b = __builtin_ctzll(bits);
        bits &= bits - 1;
        const int64_t key = (w << 6) | b;
        const int32_t child = static_cast<int32_t>(key / vocab);
        const int32_t par = static_cast<int32_t>(key % vocab);
        out->ss_child.push_back(child);
        out->ss_parent.push_back(par);
        out->ss_val.push_back(1.0f /
                              static_cast<float>(sc.outdeg_dup[par]));
      }
    }
  } else {
    // Fallback (vocab past the bitmap budget): two-pass stable counting
    // sort of the (child, parent) instances — by parent, then by child.
    const int64_t m_p = static_cast<int64_t>(sc.edge_child.size());
    std::vector<int64_t> par_off(vocab + 1, 0);
    for (int64_t p = 0; p < m_p; ++p) ++par_off[sc.edge_parent[p] + 1];
    for (int64_t o = 0; o < vocab; ++o) par_off[o + 1] += par_off[o];
    std::vector<int64_t> pcur(par_off.begin(), par_off.end());
    std::vector<int32_t> by_parent_child(m_p);
    for (int64_t p = 0; p < m_p; ++p)
      by_parent_child[pcur[sc.edge_parent[p]]++] = sc.edge_child[p];
    std::vector<int64_t> ch_off(vocab + 1, 0);
    for (int64_t p = 0; p < m_p; ++p) ++ch_off[by_parent_child[p] + 1];
    for (int64_t o = 0; o < vocab; ++o) ch_off[o + 1] += ch_off[o];
    std::vector<int64_t> ccur(ch_off.begin(), ch_off.end());
    std::vector<int32_t> by_child_parent(m_p);
    {
      int64_t par = 0;
      for (int64_t p = 0; p < m_p; ++p) {
        while (p >= par_off[par + 1]) ++par;
        by_child_parent[ccur[by_parent_child[p]]++] =
            static_cast<int32_t>(par);
      }
    }
    {
      int64_t child = 0;
      int32_t prev_parent = -1;
      for (int64_t p = 0; p < m_p; ++p) {
        while (p >= ch_off[child + 1]) {
          ++child;
          prev_parent = -1;
        }
        const int32_t par = by_child_parent[p];
        if (par == prev_parent) continue;
        prev_parent = par;
        out->ss_child.push_back(static_cast<int32_t>(child));
        out->ss_parent.push_back(par);
        out->ss_val.push_back(1.0f /
                              static_cast<float>(sc.outdeg_dup[par]));
      }
    }
  }

}

}  // namespace

extern "C" {

// ``collapse_mode``: 0 = per-trace layout, 1 = kind-collapse when the
// combined trace axis shrinks (graph/build.py collapse="auto"), 2 =
// always collapse. Collapsing happens BEFORE the incidence emit, so the
// per-trace entry arrays are never materialized.
//
// ``parent_base``: value subtracted from each parent_row entry to map it
// into this call's row space (callers passing a [lo, hi) table slice
// hand the ABSOLUTE parent rows + lo; remapping inline here replaced an
// O(window) numpy pass that cost more than the whole build). Out-of-
// range results — absent parents (-1 absolute) and parents outside the
// slice — drop the edge exactly like the old -1 convention.
MrBuiltWindow* mr_build_window2(const int32_t* pod_op, const int32_t* trace_id,
                                const int64_t* parent_row, int64_t n_rows,
                                const uint8_t* row_mask,
                                const uint8_t* normal_flag,
                                const uint8_t* abnormal_flag,
                                int64_t n_total_traces, int64_t vocab_size,
                                int32_t collapse_mode, int64_t parent_base) {
  MrBuiltWindow* g = nullptr;
  try {
    g = new MrBuiltWindow();

    // Combined membership code per global trace: bit0=normal, bit1=abnormal
    // (one cache line probe per row instead of two).
    std::vector<uint8_t> part_bit(n_total_traces);
    for (int64_t t = 0; t < n_total_traces; ++t)
      part_bit[t] =
          static_cast<uint8_t>((normal_flag[t] != 0) | ((abnormal_flag[t] != 0) << 1));

    // Bitmap-vs-instance-list choice: the bitmap wins when its memset
    // (vocab^2/64 words per partition) is small next to the rows it
    // dedups — a small masked window over a big table vocab must NOT
    // pay a fixed multi-MB clear per build, so require the word count
    // to stay within 8x the effective row count.
    int64_t n_eff = n_rows;
    if (row_mask) {
      n_eff = 0;
      for (int64_t r = 0; r < n_rows; ++r) n_eff += row_mask[r] != 0;
    }
    const int64_t bitmap_words = (vocab_size * vocab_size + 63) / 64;
    const bool edge_bitmap = vocab_size <= edge_bitmap_max_vocab() &&
                             bitmap_words <= n_eff * 8;
    PartScratch sc[2];
    for (PartScratch& s : sc) {
      s.counts_global.assign(n_total_traces, 0);
      s.cov_dup.assign(vocab_size, 0);
      s.outdeg_dup.assign(vocab_size, 0);
      if (edge_bitmap) {
        s.edge_bits.assign(static_cast<size_t>(bitmap_words), 0);
      } else if (!row_mask) {  // full-table: edges ~ rows; windows grow
        s.edge_child.reserve(n_rows / 2);
        s.edge_parent.reserve(n_rows / 2);
      }
    }

    // Fused stats pass: one scan accumulates BOTH partitions' per-trace
    // counts, per-op duplicate coverage, and call-edge instances
    // (preprocess_data.py:157-158 linkage: child row in the partition,
    // parent span inside the window, parent's trace in the partition).
    std::optional<PhaseTimer> tm_scan;
    if (profile_enabled()) tm_scan.emplace("stats-scan");
    for (int64_t r = 0; r < n_rows; ++r) {
      if (row_mask && !row_mask[r]) continue;
      const int32_t t = trace_id[r];
      const uint8_t code = part_bit[t];
      if (!code) continue;
      const int32_t op = pod_op[r];
      const int64_t pr = parent_row[r] - parent_base;
      const auto record_edge = [&](PartScratch& s, int32_t child,
                                   int32_t parent) {
        ++s.outdeg_dup[parent];
        if (edge_bitmap) {
          const uint64_t key =
              static_cast<uint64_t>(child) * vocab_size + parent;
          s.edge_bits[key >> 6] |= 1ull << (key & 63);
        } else {
          s.edge_child.push_back(child);
          s.edge_parent.push_back(parent);
        }
      };
      if (code != 3) {
        // The common case: detection partitions are disjoint, so a row
        // belongs to exactly one partition — no inner loop.
        PartScratch& s = sc[code >> 1];
        ++s.counts_global[t];
        ++s.cov_dup[op];
        ++s.n_p;
        if (pr >= 0 && pr < n_rows && (!row_mask || row_mask[pr]) &&
            (part_bit[trace_id[pr]] & code)) {
          record_edge(s, op, pod_op[pr]);
        }
        continue;
      }
      // Rare: a caller listed the trace in BOTH partitions.
      uint8_t ecode = 0;
      int32_t pop = 0;
      if (pr >= 0 && pr < n_rows && (!row_mask || row_mask[pr])) {
        ecode = static_cast<uint8_t>(code & part_bit[trace_id[pr]]);
        pop = pod_op[pr];
      }
      for (int i = 0; i < 2; ++i) {
        PartScratch& s = sc[i];
        ++s.counts_global[t];
        ++s.cov_dup[op];
        ++s.n_p;
        if (ecode & (1 << i)) record_edge(s, op, pop);
      }
    }

    if (profile_enabled()) tm_scan.emplace("scatter");

    // Local trace interning in ascending global-id order (np.unique
    // order), then ONE more scan bucket-scatters both partitions' ops by
    // local trace — buckets are small (avg spans/trace), so the per-trace
    // sorts in finish_partition stay in cache.
    for (int i = 0; i < 2; ++i) {
      PartScratch& s = sc[i];
      s.local_id.assign(n_total_traces, -1);
      auto& lu = g->parts[i].local_uniques;
      auto& tl = g->parts[i].tracelen;
      for (int64_t t = 0; t < n_total_traces; ++t) {
        if (s.counts_global[t] > 0) {
          s.local_id[t] = static_cast<int32_t>(lu.size());
          lu.push_back(static_cast<int32_t>(t));
          tl.push_back(s.counts_global[t]);
        }
      }
      s.tr_off.assign(lu.size() + 1, 0);
      for (size_t t = 0; t < lu.size(); ++t)
        s.tr_off[t + 1] = s.tr_off[t] + tl[t];
      s.by_trace_op.resize(s.n_p);
    }
    {
      std::vector<int64_t> cur0(sc[0].tr_off.begin(), sc[0].tr_off.end());
      std::vector<int64_t> cur1(sc[1].tr_off.begin(), sc[1].tr_off.end());
      for (int64_t r = 0; r < n_rows; ++r) {
        if (row_mask && !row_mask[r]) continue;
        const int32_t t = trace_id[r];
        const uint8_t code = part_bit[t];
        if (!code) continue;
        const int32_t op = pod_op[r];
        if (code & 1) sc[0].by_trace_op[cur0[sc[0].local_id[t]]++] = op;
        if (code & 2) sc[1].by_trace_op[cur1[sc[1].local_id[t]]++] = op;
      }
    }

    tm_scan.reset();

    // Finish the partitions sequentially: each call parallelizes ACROSS
    // its trace chunks (parallel_chunks), which balances arbitrarily
    // skewed partitions — the old one-thread-per-partition overlap
    // bought nothing when one partition held 40x the entries (the usual
    // detection outcome). Analyze both first: the auto collapse
    // decision needs both partitions' kind-group counts before either
    // emits.
    analyze_partition(sc[0], vocab_size, &g->parts[0]);
    analyze_partition(sc[1], vocab_size, &g->parts[1]);
    const int64_t t_total =
        static_cast<int64_t>(g->parts[0].local_uniques.size()) +
        static_cast<int64_t>(g->parts[1].local_uniques.size());
    const int64_t grp_total = g->parts[0].n_groups + g->parts[1].n_groups;
    const bool do_collapse =
        collapse_mode == 2 || (collapse_mode == 1 && grp_total < t_total);
    emit_partition(sc[0], &g->parts[0], do_collapse);
    emit_partition(sc[1], &g->parts[1], do_collapse);
    edges_partition(sc[0], vocab_size, &g->parts[0]);
    edges_partition(sc[1], vocab_size, &g->parts[1]);
  } catch (const std::bad_alloc&) {
    delete g;
    return nullptr;
  } catch (const std::system_error&) {  // thread creation failure
    delete g;
    return nullptr;
  } catch (const std::exception& e) {
    // Never cross the C ABI with an exception. Allocation/thread
    // failures above stay silent (the Python side falls back to the
    // numpy lane); anything else is a real bug — say what it was
    // before reporting the generic build failure.
    std::fprintf(stderr, "mr_build_window2: unexpected error: %s\n",
                 e.what());
    delete g;
    return nullptr;
  } catch (...) {
    delete g;
    return nullptr;
  }
  return g;
}

// Query whether mr_build_window2 collapsed the trace axes (its
// collapse_mode argument): returns 1 and fills out_true[i] with each
// partition's TRUE trace count when kind-collapsed (mr_window_sizes then
// reports the kind-COLUMN counts), 0 when the per-trace layout was kept.
int32_t mr_collapse_window(const MrBuiltWindow* g, int32_t /*unused*/,
                           int64_t* out_true) {
  if (g->parts[0].n_traces_true < 0) return 0;
  out_true[0] = g->parts[0].n_traces_true;
  out_true[1] = g->parts[1].n_traces_true;
  return 1;
}

// sizes[8]: per partition (normal, abnormal): n_inc, n_ss, n_traces, n_ops.
// After mr_collapse_window, "n_traces" is the kind-COLUMN count (the
// padded trace-axis extent); the true counts come from that call.
void mr_window_sizes(const MrBuiltWindow* g, int64_t* sizes) {
  for (int i = 0; i < 2; ++i) {
    const BuiltPartition& p = g->parts[i];
    sizes[4 * i + 0] = static_cast<int64_t>(p.inc_op.size());
    sizes[4 * i + 1] = static_cast<int64_t>(p.ss_child.size());
    sizes[4 * i + 2] = static_cast<int64_t>(p.kind.size());
    sizes[4 * i + 3] = p.n_ops;
  }
}

// Copy partition idx into caller-allocated buffers (each at least the
// corresponding mr_window_sizes length; vocab-length for cov/present).
// Buffers beyond the filled length keep whatever the caller padded with.
void mr_export_partition(const MrBuiltWindow* g, int32_t idx, int32_t* inc_op,
                         int32_t* inc_trace, float* sr_val, float* rs_val,
                         int32_t* ss_child, int32_t* ss_parent, float* ss_val,
                         int32_t* kind, int32_t* tracelen,
                         int32_t* local_uniques, int32_t* cov_unique,
                         uint8_t* op_present) {
  const BuiltPartition& p = g->parts[idx];
  auto cp = [](auto* dst, const auto& src) {
    if (!src.empty())
      std::memcpy(dst, src.data(), src.size() * sizeof(src[0]));
  };
  cp(inc_op, p.inc_op);
  cp(inc_trace, p.inc_trace);
  cp(sr_val, p.sr_val);
  cp(rs_val, p.rs_val);
  cp(ss_child, p.ss_child);
  cp(ss_parent, p.ss_parent);
  cp(ss_val, p.ss_val);
  cp(kind, p.kind);
  cp(tracelen, p.tracelen);
  cp(local_uniques, p.local_uniques);
  cp(cov_unique, p.cov_unique);
  cp(op_present, p.op_present);
}

// Packed-kernel views: 0/1 pattern bitmaps (big-endian bit order, matching
// np.packbits) plus the three inverse vectors, written into caller-ZEROED
// padded buffers. ``t8``/``v8`` are the bitmap row strides in bytes
// (= t_pad/8, v_pad/8 rounded up). inv values copy the same f32 the COO
// value arrays carry, so the packed kernel is value-identical to it.
void mr_export_bitmaps(const MrBuiltWindow* g, int32_t idx, uint8_t* cov_bits,
                       int64_t t8, uint8_t* ss_bits, int64_t v8,
                       float* inv_len, float* inv_cov, float* inv_out) {
  const BuiltPartition& p = g->parts[idx];
  const int64_t n_inc = static_cast<int64_t>(p.inc_op.size());
  for (int64_t i = 0; i < n_inc; ++i) {
    const int32_t v = p.inc_op[i], t = p.inc_trace[i];
    cov_bits[static_cast<int64_t>(v) * t8 + (t >> 3)] |=
        static_cast<uint8_t>(128u >> (t & 7));
    inv_cov[v] = p.rs_val[i];
    // Scattered from the entry values (not recomputed as 1/len) so the
    // kind-collapsed layout's folded m/len forward weights carry over
    // exactly — identical to graph/build.py:packed_aux either way.
    inv_len[t] = p.sr_val[i];
  }
  const int64_t n_ss = static_cast<int64_t>(p.ss_child.size());
  for (int64_t i = 0; i < n_ss; ++i) {
    const int32_t c = p.ss_child[i], par = p.ss_parent[i];
    ss_bits[static_cast<int64_t>(c) * v8 + (par >> 3)] |=
        static_cast<uint8_t>(128u >> (par & 7));
    inv_out[par] = p.ss_val[i];
  }
}

// CSR-kernel views: op-major reorder of the incidence (stable counting
// scatter — entries are stored trace-major with ops ascending per trace,
// so op rows keep traces ascending) plus the three row-offset arrays.
// Caller-zeroed buffers: tr_om/sr_om e_pad-length, indptr_op/ss_indptr
// (v_pad+1)-length, indptr_trace (t_pad+1)-length.
void mr_export_csr(const MrBuiltWindow* g, int32_t idx, int64_t vocab,
                   int64_t v_pad, int64_t t_pad, int32_t* tr_om, float* sr_om,
                   int32_t* indptr_op, int32_t* indptr_trace,
                   int32_t* ss_indptr) {
  const BuiltPartition& p = g->parts[idx];
  const int64_t n_inc = static_cast<int64_t>(p.inc_op.size());
  // Histogram the CURRENT incidence — cov_unique keeps the true
  // per-trace coverage counts, which overcount the entries after a
  // kind collapse (one entry per covering kind, not per trace).
  std::vector<int32_t> op_count(vocab, 0);
  for (int64_t i = 0; i < n_inc; ++i) ++op_count[p.inc_op[i]];
  indptr_op[0] = 0;
  for (int64_t o = 0; o < v_pad; ++o)
    indptr_op[o + 1] = indptr_op[o] + (o < vocab ? op_count[o] : 0);
  std::vector<int32_t> cur(indptr_op, indptr_op + vocab);
  for (int64_t i = 0; i < n_inc; ++i) {
    const int32_t pos = cur[p.inc_op[i]]++;
    tr_om[pos] = p.inc_trace[i];
    sr_om[pos] = p.sr_val[i];
  }
  for (int64_t i = 0; i < n_inc; ++i) ++indptr_trace[p.inc_trace[i] + 1];
  for (int64_t t = 0; t < t_pad; ++t) indptr_trace[t + 1] += indptr_trace[t];
  const int64_t n_ss = static_cast<int64_t>(p.ss_child.size());
  for (int64_t i = 0; i < n_ss; ++i) ++ss_indptr[p.ss_child[i] + 1];
  for (int64_t o = 0; o < v_pad; ++o) ss_indptr[o + 1] += ss_indptr[o];
}

// The column identity of partition idx (the warm start's trace axis,
// rank_backends/warm.py): for each coverage column, the local trace
// index it stands for, written to cols[0 .. columns). Kind-collapsed: a
// group's representative, its lowest local trace (the trace emit_partition
// takes the group's entries from); else the identity. Returns the
// number of columns written.
int64_t mr_export_columns(const MrBuiltWindow* g, int32_t idx, int32_t* cols) {
  const BuiltPartition& p = g->parts[idx];
  if (p.n_traces_true < 0) {
    const int64_t n = static_cast<int64_t>(p.kind.size());
    for (int64_t t = 0; t < n; ++t) cols[t] = static_cast<int32_t>(t);
    return n;
  }
  const int64_t n_groups = p.n_groups;
  for (int64_t c = 0; c < n_groups; ++c) cols[c] = -1;
  const int64_t n_traces = static_cast<int64_t>(p.group_of.size());
  for (int64_t t = 0; t < n_traces; ++t) {
    const int32_t c = p.group_of[t];
    if (cols[c] < 0) cols[c] = static_cast<int32_t>(t);
  }
  return n_groups;
}

void mr_free_built(MrBuiltWindow* g) { delete g; }

}  // extern "C"
