// Fused window detector (reference components C1+C4+C5 in one scan).
//
// The numpy detect path (graph/table_ops.py detect_batch_from_table +
// detect/detector.py detect_numpy) makes several full passes over the
// window's spans: window mask, fancy-index gathers of op/trace/duration,
// per-trace bincount of SLO thresholds, and a per-trace duration max. At
// 1M spans that is ~45 ms; at the 16M-span stress shape it reaches
// ~1.7 s and dominates the window. This fused scan computes the SAME
// quantities in one pass over the table — window mask, per-trace
// expected = sum of mu+k*sigma over known ops (anormaly_detector.py:
// 64-65; unknown ops contribute 0 via the bare-except rule :66-67),
// per-trace real = max span duration (preprocess_data.py:110) — and then
// emits the normal/abnormal trace-id partitions ascending.
//
// Numeric parity with detect_numpy is exact by construction:
//   * expected accumulates float64 over float32 thresholds in row order
//     (numpy: bincount weights promote f32->f64, summed in row order),
//     compared as float32;
//   * real converts the int64 max to float32 then divides by 1000.0f
//     (numpy converts each duration to f32 BEFORE the max — f32
//     conversion is monotone, so max-then-convert is value-identical);
//   * abnormal iff real_ms > float32(expected) + slack_ms, valid iff
//     real_ms > 0 (detect/detector.py:56-66).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Returns 0 on success. Caller allocates:
//   mask      uint8[n_spans]       (1 = span inside [w0, w1])
//   nrm, abn  int32[n_traces_total] (filled prefixes, ascending ids)
//   counts    int64[4] = {n_nrm, n_abn, n_window_spans, n_traces_seen}
int mr_detect_window(
    int64_t n_spans,
    const int32_t* trace_id,
    const int32_t* svc_op,
    const int64_t* duration_us,
    const int64_t* start_us,
    const int64_t* end_us,
    int64_t w0_us,
    int64_t w1_us,
    const int32_t* remap,      // table svc-op id -> SLO vocab id or -1
    int64_t n_svc_vocab,
    const float* thresh_ms,    // mu + k*sigma per SLO vocab id
    int64_t n_slo_vocab,
    float slack_ms,
    int64_t n_traces_total,
    uint8_t* mask,
    int32_t* nrm,
    int32_t* abn,
    int64_t* counts) {
  std::vector<double> expected(static_cast<size_t>(n_traces_total), 0.0);
  std::vector<int64_t> real_us(static_cast<size_t>(n_traces_total),
                               INT64_MIN);
  std::vector<uint8_t> seen(static_cast<size_t>(n_traces_total), 0);

  int64_t n_window = 0;
  for (int64_t i = 0; i < n_spans; ++i) {
    const bool in = start_us[i] >= w0_us && end_us[i] <= w1_us;
    mask[i] = in ? 1 : 0;
    if (!in) continue;
    ++n_window;
    const int32_t t = trace_id[i];
    if (t < 0 || t >= n_traces_total) continue;  // defensive; loader ids
    seen[t] = 1;
    const int32_t op = svc_op[i];
    if (op >= 0 && op < n_svc_vocab) {
      const int32_t m = remap[op];
      if (m >= 0 && m < n_slo_vocab) {
        expected[t] += static_cast<double>(thresh_ms[m]);
      }
    }
    if (duration_us[i] > real_us[t]) real_us[t] = duration_us[i];
  }

  int64_t n_nrm = 0, n_abn = 0, n_seen = 0;
  for (int64_t t = 0; t < n_traces_total; ++t) {
    if (!seen[t]) continue;
    ++n_seen;
    const float real_ms = static_cast<float>(real_us[t]) / 1000.0f;
    if (!(real_ms > 0.0f)) continue;  // valid traces only, like numpy
    const float exp_ms = static_cast<float>(expected[t]);
    if (real_ms > exp_ms + slack_ms) {
      abn[n_abn++] = static_cast<int32_t>(t);
    } else {
      nrm[n_nrm++] = static_cast<int32_t>(t);
    }
  }
  counts[0] = n_nrm;
  counts[1] = n_abn;
  counts[2] = n_window;
  counts[3] = n_seen;
  return 0;
}

}  // extern "C"
