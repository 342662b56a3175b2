// Native span-table loader: mmap CSV -> interned int32 arrays, one pass.
//
// The ingest stage of the framework (reference L1: the traces.csv contract
// of collect_data.py:36-46 / online_rca.py:221-248). The Python path is
// pandas read_csv + three factorize passes + a positional parent lookup;
// this does tokenization, canonical operation naming (including the
// strip-last-URL-segment rule for configured services,
// preprocess_data.py:27-31), vocabulary interning (trace ids, service-level
// ops, pod-level ops), duration/datetime parsing, and ParentSpanId->row
// resolution in a single scan over the memory-mapped file.
//
// Plain C ABI (ctypes-friendly); all output arrays are heap-allocated and
// released with mr_free_table. Strings in vocabularies are returned as one
// concatenated UTF-8 blob plus int64 offsets.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// String interner with an open-addressing probe table keyed by views into
// the growing blob — no per-lookup std::string allocation (the hot path
// runs 3x per span row).
struct Vocab {
  std::string blob;
  std::vector<int64_t> offsets{0};
  std::vector<int32_t> slots;  // id+1; 0 = empty
  size_t mask = 0;

  Vocab() : slots(1024, 0), mask(1023) {}

  static uint64_t hash(std::string_view s) {
    uint64_t h = 1469598103934665603ULL;  // FNV-1a
    for (char c : s) {
      h ^= static_cast<unsigned char>(c);
      h *= 1099511628211ULL;
    }
    return h;
  }

  std::string_view at(int32_t id) const {
    return std::string_view(blob)
        .substr(static_cast<size_t>(offsets[id]),
                static_cast<size_t>(offsets[id + 1] - offsets[id]));
  }

  void grow() {
    std::vector<int32_t> fresh(slots.size() * 2, 0);
    const size_t m = fresh.size() - 1;
    for (int32_t v : slots) {
      if (!v) continue;
      size_t i = hash(at(v - 1)) & m;
      while (fresh[i]) i = (i + 1) & m;
      fresh[i] = v;
    }
    slots.swap(fresh);
    mask = m;
  }

  int32_t intern(std::string_view s) {
    size_t i = hash(s) & mask;
    while (slots[i]) {
      const int32_t id = slots[i] - 1;
      if (at(id) == s) return id;
      i = (i + 1) & mask;
    }
    const int32_t id = static_cast<int32_t>(offsets.size()) - 1;
    blob.append(s.data(), s.size());
    offsets.push_back(static_cast<int64_t>(blob.size()));
    slots[i] = id + 1;
    if ((offsets.size() - 1) * 2 > slots.size()) grow();
    return id;
  }
  size_t size() const { return offsets.size() - 1; }
};

// Days-from-civil (Howard Hinnant's algorithm) -> epoch days.
int64_t days_from_civil(int y, int m, int d) {
  y -= m <= 2;
  const int era = (y >= 0 ? y : y - 399) / 400;
  const unsigned yoe = static_cast<unsigned>(y - era * 400);
  const unsigned doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  const unsigned doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return static_cast<int64_t>(era) * 146097 + static_cast<int64_t>(doe) -
         719468;
}

// Parse "YYYY-MM-DD HH:MM:SS[.frac]" (or 'T' separator) to epoch micros.
// Returns INT64_MIN on failure.
int64_t parse_datetime_us(std::string_view s) {
  if (s.size() < 19) return INT64_MIN;
  auto digit = [](char c) { return c >= '0' && c <= '9'; };
  for (int i : {0, 1, 2, 3, 5, 6, 8, 9, 11, 12, 14, 15, 17, 18})
    if (!digit(s[static_cast<size_t>(i)])) return INT64_MIN;
  int y = (s[0] - '0') * 1000 + (s[1] - '0') * 100 + (s[2] - '0') * 10 +
          (s[3] - '0');
  int mo = (s[5] - '0') * 10 + (s[6] - '0');
  int d = (s[8] - '0') * 10 + (s[9] - '0');
  int h = (s[11] - '0') * 10 + (s[12] - '0');
  int mi = (s[14] - '0') * 10 + (s[15] - '0');
  int se = (s[17] - '0') * 10 + (s[18] - '0');
  int64_t us = (days_from_civil(y, mo, d) * 86400LL +
                h * 3600LL + mi * 60LL + se) *
               1000000LL;
  if (s.size() > 20 && s[19] == '.') {
    int64_t frac = 0;
    int ndig = 0;
    for (size_t i = 20; i < s.size() && ndig < 6; ++i, ++ndig) {
      if (!digit(s[i])) break;
      frac = frac * 10 + (s[i] - '0');
    }
    while (ndig < 6) {
      frac *= 10;
      ++ndig;
    }
    us += frac;
  }
  return us;
}

int64_t parse_int(std::string_view s) {
  int64_t v = 0;
  bool neg = false;
  size_t i = 0;
  if (i < s.size() && (s[i] == '-' || s[i] == '+')) neg = s[i++] == '-';
  for (; i < s.size(); ++i) {
    char c = s[i];
    if (c < '0' || c > '9') break;
    v = v * 10 + (c - '0');
  }
  return neg ? -v : v;
}

struct CsvReader {
  const char* p;
  const char* end;
  std::string scratch;  // for quoted fields with escapes

  // Read one field; returns view (may point into scratch). Sets
  // end_of_line / end_of_file flags.
  std::string_view field(bool& eol, bool& eof) {
    eol = eof = false;
    if (p >= end) {
      eof = true;
      return {};
    }
    if (*p == '"') {
      ++p;
      scratch.clear();
      const char* start = p;
      bool used_scratch = false;
      while (p < end) {
        if (*p == '"') {
          if (p + 1 < end && p[1] == '"') {  // escaped quote
            if (!used_scratch) {
              scratch.assign(start, p - start);
              used_scratch = true;
            } else {
              scratch.append(start, p - start);
            }
            scratch.push_back('"');
            p += 2;
            start = p;
            continue;
          }
          std::string_view out;
          if (used_scratch) {
            scratch.append(start, p - start);
            out = scratch;
          } else {
            out = {start, static_cast<size_t>(p - start)};
          }
          ++p;  // closing quote
          consume_sep(eol, eof);
          return out;
        }
        ++p;
      }
      eof = true;
      return used_scratch ? std::string_view(scratch)
                          : std::string_view(start,
                                             static_cast<size_t>(p - start));
    }
    const char* start = p;
    while (p < end && *p != ',' && *p != '\n' && *p != '\r') ++p;
    std::string_view out{start, static_cast<size_t>(p - start)};
    consume_sep(eol, eof);
    return out;
  }

  void consume_sep(bool& eol, bool& eof) {
    if (p >= end) {
      eof = true;
      return;
    }
    if (*p == ',') {
      ++p;
      return;
    }
    if (*p == '\r') ++p;
    if (p < end && *p == '\n') {
      ++p;
      eol = true;
      if (p >= end) eof = true;
      return;
    }
    if (p >= end) eof = true;
  }
};

struct ColMap {
  int trace = -1, span = -1, parent = -1, opname = -1, service = -1,
      pod = -1, duration = -1, start = -1, endt = -1;
  int n_cols = 0;
};

bool match(std::string_view h, const char* a, const char* b) {
  return h == a || h == b;
}

}  // namespace

extern "C" {

struct MrSpanTable {
  int64_t n_spans;
  // per-span arrays
  int32_t* trace_id;
  int32_t* svc_op;     // service-level operation id (detector/SLO vocab)
  int32_t* pod_op;     // instance-level operation id (PageRank vocab)
  int64_t* duration_us;
  int64_t* start_us;   // trace-level start, epoch micros
  int64_t* end_us;     // trace-level end, epoch micros
  int64_t* parent_row; // row index of the parent span, -1 if absent
  // vocabularies (concatenated blob + offsets, len = n+1)
  char* trace_blob;
  int64_t* trace_offsets;
  int64_t n_traces;
  char* svc_blob;
  int64_t* svc_offsets;
  int64_t n_svc_ops;
  char* pod_blob;
  int64_t* pod_offsets;
  int64_t n_pod_ops;
  char* error;  // non-null on failure
};

static char* dup_error(const std::string& msg) {
  char* e = static_cast<char*>(std::malloc(msg.size() + 1));
  std::memcpy(e, msg.c_str(), msg.size() + 1);
  return e;
}

void mr_free_table(MrSpanTable* t) {
  if (!t) return;
  delete[] t->trace_id;
  delete[] t->svc_op;
  delete[] t->pod_op;
  delete[] t->duration_us;
  delete[] t->start_us;
  delete[] t->end_us;
  delete[] t->parent_row;
  delete[] t->trace_blob;
  delete[] t->trace_offsets;
  delete[] t->svc_blob;
  delete[] t->svc_offsets;
  delete[] t->pod_blob;
  delete[] t->pod_offsets;
  std::free(t->error);
  delete t;
}

// strip_services: comma-separated service names whose operation names lose
// their last '/'-segment (the reference hard-codes "ts-ui-dashboard").
MrSpanTable* mr_load_csv(const char* path, const char* strip_services) {
  auto* out = new MrSpanTable();
  std::memset(out, 0, sizeof(MrSpanTable));

  int fd = ::open(path, O_RDONLY);
  if (fd < 0) {
    out->error = dup_error(std::string("cannot open ") + path);
    return out;
  }
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    ::close(fd);
    out->error = dup_error("empty or unreadable file");
    return out;
  }
  size_t size = static_cast<size_t>(st.st_size);
  void* mem = ::mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (mem == MAP_FAILED) {
    out->error = dup_error("mmap failed");
    return out;
  }

  std::unordered_map<std::string, bool> strip;
  {
    std::string_view s(strip_services ? strip_services : "");
    while (!s.empty()) {
      size_t c = s.find(',');
      std::string_view tok = s.substr(0, c);
      if (!tok.empty()) strip.emplace(std::string(tok), true);
      s = (c == std::string_view::npos) ? std::string_view{} : s.substr(c + 1);
    }
  }

  CsvReader r{static_cast<const char*>(mem),
              static_cast<const char*>(mem) + size,
              {}};

  // Header: accept both the raw ClickHouse export names and the canonical
  // renamed schema (online_rca.py:222-232).
  ColMap cols;
  {
    bool eol = false, eof = false;
    int i = 0;
    while (!eol && !eof) {
      std::string_view h = r.field(eol, eof);
      if (match(h, "TraceId", "traceID")) cols.trace = i;
      else if (match(h, "SpanId", "spanID")) cols.span = i;
      else if (match(h, "ParentSpanId", "ParentSpanId")) cols.parent = i;
      else if (match(h, "SpanName", "operationName")) cols.opname = i;
      else if (match(h, "ServiceName", "serviceName")) cols.service = i;
      else if (match(h, "PodName", "podName")) cols.pod = i;
      else if (match(h, "Duration", "duration")) cols.duration = i;
      else if (match(h, "TraceStart", "startTime")) cols.start = i;
      else if (match(h, "TraceEnd", "endTime")) cols.endt = i;
      ++i;
    }
    cols.n_cols = i;
    if (cols.trace < 0 || cols.span < 0 || cols.parent < 0 ||
        cols.opname < 0 || cols.service < 0 || cols.pod < 0 ||
        cols.duration < 0 || cols.start < 0 || cols.endt < 0) {
      ::munmap(mem, size);
      out->error = dup_error("missing required columns in CSV header");
      return out;
    }
  }

  Vocab traces, svc_ops, pod_ops;
  std::unordered_map<std::string, int64_t> span_row;
  std::vector<int32_t> trace_id, svc_op, pod_op;
  std::vector<int64_t> duration_us, start_us, end_us;
  std::vector<std::string> parent_raw_arena;  // parent span ids per row
  std::string name_buf;

  bool eof = false;
  std::vector<std::string_view> fields(static_cast<size_t>(cols.n_cols));
  std::vector<std::string> field_copies(static_cast<size_t>(cols.n_cols));
  while (!eof) {
    bool eol = false;
    int i = 0;
    bool any = false;
    while (!eol && !eof && i < cols.n_cols) {
      std::string_view f = r.field(eol, eof);
      // Quoted fields may point into the shared scratch; copy them.
      if (f.data() == r.scratch.data()) {
        field_copies[static_cast<size_t>(i)].assign(f);
        f = field_copies[static_cast<size_t>(i)];
      }
      fields[static_cast<size_t>(i)] = f;
      any = any || !f.empty();
      ++i;
    }
    // Drain any extra fields on the line.
    while (!eol && !eof) r.field(eol, eof);
    if (!any || i < cols.n_cols) continue;

    int64_t row = static_cast<int64_t>(trace_id.size());
    std::string_view svc = fields[static_cast<size_t>(cols.service)];
    std::string_view op = fields[static_cast<size_t>(cols.opname)];
    std::string_view pod = fields[static_cast<size_t>(cols.pod)];
    std::string_view sp = fields[static_cast<size_t>(cols.span)];
    std::string_view pa = fields[static_cast<size_t>(cols.parent)];

    // Canonical naming (preprocess_data.py:27-31): strip the last
    // '/'-segment of the operation for configured services.
    std::string_view op_eff = op;
    if (!strip.empty() && strip.count(std::string(svc))) {
      size_t slash = op.rfind('/');
      if (slash != std::string_view::npos) op_eff = op.substr(0, slash);
    }
    name_buf.assign(svc.data(), svc.size());
    name_buf.push_back('_');
    name_buf.append(op_eff.data(), op_eff.size());
    svc_op.push_back(svc_ops.intern(name_buf));

    name_buf.assign(pod.data(), pod.size());
    name_buf.push_back('_');
    name_buf.append(op_eff.data(), op_eff.size());
    pod_op.push_back(pod_ops.intern(name_buf));

    trace_id.push_back(traces.intern(fields[static_cast<size_t>(cols.trace)]));
    duration_us.push_back(
        parse_int(fields[static_cast<size_t>(cols.duration)]));
    start_us.push_back(
        parse_datetime_us(fields[static_cast<size_t>(cols.start)]));
    end_us.push_back(parse_datetime_us(fields[static_cast<size_t>(cols.endt)]));

    span_row[std::string(sp)] = row;
    parent_raw_arena.emplace_back(pa);
  }
  ::munmap(mem, size);

  int64_t n = static_cast<int64_t>(trace_id.size());
  auto copy_i32 = [](const std::vector<int32_t>& v) {
    auto* a = new int32_t[v.size()];
    std::memcpy(a, v.data(), v.size() * sizeof(int32_t));
    return a;
  };
  auto copy_i64 = [](const std::vector<int64_t>& v) {
    auto* a = new int64_t[v.size()];
    std::memcpy(a, v.data(), v.size() * sizeof(int64_t));
    return a;
  };

  out->n_spans = n;
  out->trace_id = copy_i32(trace_id);
  out->svc_op = copy_i32(svc_op);
  out->pod_op = copy_i32(pod_op);
  out->duration_us = copy_i64(duration_us);
  out->start_us = copy_i64(start_us);
  out->end_us = copy_i64(end_us);

  out->parent_row = new int64_t[static_cast<size_t>(n)];
  for (int64_t i = 0; i < n; ++i) {
    const std::string& pa = parent_raw_arena[static_cast<size_t>(i)];
    if (pa.empty()) {
      out->parent_row[i] = -1;
      continue;
    }
    auto it = span_row.find(pa);
    out->parent_row[i] = (it == span_row.end()) ? -1 : it->second;
  }

  auto emit_vocab = [](Vocab& v, char** blob, int64_t** offsets,
                       int64_t* count) {
    *blob = new char[v.blob.size() + 1];
    std::memcpy(*blob, v.blob.data(), v.blob.size());
    (*blob)[v.blob.size()] = 0;
    *offsets = new int64_t[v.offsets.size()];
    std::memcpy(*offsets, v.offsets.data(),
                v.offsets.size() * sizeof(int64_t));
    *count = static_cast<int64_t>(v.size());
  };
  emit_vocab(traces, &out->trace_blob, &out->trace_offsets, &out->n_traces);
  emit_vocab(svc_ops, &out->svc_blob, &out->svc_offsets, &out->n_svc_ops);
  emit_vocab(pod_ops, &out->pod_blob, &out->pod_offsets, &out->n_pod_ops);
  return out;
}

}  // extern "C"
