// Native evaluation decoders (C++, ctypes ABI), built with g++ by
// texttoaudiogrounding_tpu_torch/native/__init__.py.
//
// A copy of texttoaudiogrounding_tpu/native/decode.cpp's three decoders:
// the per-track multi-threshold decode (binarize -> median filter ->
// connect clusters -> contiguous regions) and the exact PSD-ROC per-file
// count sweeps, without and with cross-triggers (one region extraction
// and intersection pass per unique score).  The NumPy versions in
// evaluation/decode.py and evaluation/psds.py are the plain versions;
// these give the same results bit for bit.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Binary median filter with reflect boundary (scipy.ndimage.median_filter
// semantics: rank w/2 of the sorted window == 1 iff #ones >= w - w/2).
static void median_filter_binary(const uint8_t* in, uint8_t* out, int t,
                                 int window) {
  if (window <= 1) {
    std::memcpy(out, in, t);
    return;
  }
  const int left = window / 2;
  const int need = window - window / 2;  // ones needed for median == 1
  for (int i = 0; i < t; ++i) {
    int ones = 0;
    for (int k = 0; k < window; ++k) {
      int idx = i - left + k;
      // scipy 'reflect' (a b c -> b a | a b c | c b)
      while (idx < 0 || idx >= t) {
        if (idx < 0) idx = -idx - 1;
        if (idx >= t) idx = 2 * t - idx - 1;
      }
      ones += in[idx];
    }
    out[i] = ones >= need ? 1 : 0;
  }
}

// Decode one score track at K thresholds.
// scores[t], thresholds[k]; emits (onset, offset) frame pairs scaled by
// time_resolution into seg_buffer (capacity cap pairs), with per-threshold
// counts in seg_counts[k].  Returns total pairs written (or -1 on
// overflow).
int decode_multi_threshold(const float* scores, int t,
                           const float* thresholds, int k, int window,
                           int connect_n, double time_resolution,
                           double* seg_buffer, int cap, int* seg_counts) {
  std::vector<uint8_t> bin(t), filt(t);
  int total = 0;
  for (int ki = 0; ki < k; ++ki) {
    const float th = thresholds[ki];
    for (int i = 0; i < t; ++i) bin[i] = scores[i] > th ? 1 : 0;
    median_filter_binary(bin.data(), filt.data(), t, window);
    // contiguous regions + gap-connect (gap <= connect_n merges)
    int count = 0;
    int i = 0;
    int cur_start = -1, cur_end = -1;
    while (i < t) {
      if (!filt[i]) { ++i; continue; }
      int start = i;
      while (i < t && filt[i]) ++i;
      int end = i;  // exclusive
      if (cur_start < 0) {
        cur_start = start; cur_end = end;
      } else if (start - cur_end <= connect_n) {
        cur_end = end;
      } else {
        if (total >= cap) return -1;
        seg_buffer[2 * total] = cur_start * time_resolution;
        seg_buffer[2 * total + 1] = cur_end * time_resolution;
        ++total; ++count;
        cur_start = start; cur_end = end;
      }
    }
    if (cur_start >= 0) {
      if (total >= cap) return -1;
      seg_buffer[2 * total] = cur_start * time_resolution;
      seg_buffer[2 * total + 1] = cur_end * time_resolution;
      ++total; ++count;
    }
    seg_counts[ki] = count;
  }
  return total;
}

// Exact PSD-ROC per-file count curves: for each unique score value
// (descending), the number of ground truths covered (GTC over DTC-valid
// detections) and the number of DTC-failing detections.
// score[t]; timestamps[t+1]; gts[2*g] as (onset, offset) pairs.
// uniques/tps/fps must have capacity t.
// Returns the number of unique thresholds written.
int file_count_curves(const float* score, int t, const double* timestamps,
                      const double* gts, int g, double dtc, double gtc,
                      float* uniques, int64_t* tps, int64_t* fps) {
  std::vector<float> sorted(score, score + t);
  std::sort(sorted.begin(), sorted.end(), std::greater<float>());
  int nu = 0;
  for (int i = 0; i < t; ++i)
    if (nu == 0 || sorted[i] != uniques[nu - 1]) uniques[nu++] = sorted[i];

  std::vector<double> gt_dur(g);
  for (int j = 0; j < g; ++j) gt_dur[j] = gts[2 * j + 1] - gts[2 * j];

  std::vector<double> coverage(g);
  for (int ui = 0; ui < nu; ++ui) {
    const float tau = uniques[ui];
    std::fill(coverage.begin(), coverage.end(), 0.0);
    int64_t tp = 0, fp = 0;
    int i = 0;
    while (i < t) {
      if (score[i] < tau) { ++i; continue; }
      int start = i;
      while (i < t && score[i] >= tau) ++i;
      const double on = timestamps[start];
      const double off = timestamps[i];
      const double dur = off - on;
      // DTC: summed intersection ratio over all gts
      double inter_sum = 0.0;
      for (int j = 0; j < g; ++j) {
        const double inter = std::min(off, gts[2 * j + 1]) -
                             std::max(on, gts[2 * j]);
        if (inter > 0) inter_sum += inter;
      }
      const bool dtc_valid = dur > 0 && inter_sum / dur >= dtc;
      if (!dtc_valid) {
        ++fp;
        continue;
      }
      for (int j = 0; j < g; ++j) {
        const double inter = std::min(off, gts[2 * j + 1]) -
                             std::max(on, gts[2 * j]);
        if (inter > 0) coverage[j] += inter;
      }
    }
    for (int j = 0; j < g; ++j)
      if (gt_dur[j] > 0 && coverage[j] / gt_dur[j] >= gtc) ++tp;
    tps[ui] = tp;
    fps[ui] = fp;
  }
  return nu;
}

// Cross-trigger variant of file_count_curves (the DESED PSDS2 CTTC
// criterion, reference utils/eval_util.py:136-223 config surface): for
// each unique threshold, DTC-failing detections are additionally
// tested per other class — summed intersection ratio vs that class's
// ground truths >= cttc counts one cross-trigger.
// others[2*sum_g] holds all other-class (onset, offset) pairs
// concatenated; other_offsets[n_other+1] delimits each class's pairs
// (in PAIR units).  cts must have capacity n_other*t, written row-major
// [n_other][nu].  Returns the number of unique thresholds written.
int file_count_curves_ct(const float* score, int t,
                         const double* timestamps, const double* gts,
                         int g, const double* others,
                         const int* other_offsets, int n_other,
                         double dtc, double gtc, double cttc,
                         float* uniques, int64_t* tps, int64_t* fps,
                         int64_t* cts) {
  std::vector<float> sorted(score, score + t);
  std::sort(sorted.begin(), sorted.end(), std::greater<float>());
  int nu = 0;
  for (int i = 0; i < t; ++i)
    if (nu == 0 || sorted[i] != uniques[nu - 1]) uniques[nu++] = sorted[i];

  std::vector<double> gt_dur(g);
  for (int j = 0; j < g; ++j) gt_dur[j] = gts[2 * j + 1] - gts[2 * j];

  std::vector<double> coverage(g);
  for (int ui = 0; ui < nu; ++ui) {
    const float tau = uniques[ui];
    std::fill(coverage.begin(), coverage.end(), 0.0);
    int64_t tp = 0, fp = 0;
    for (int c = 0; c < n_other; ++c) cts[c * t + ui] = 0;
    int i = 0;
    while (i < t) {
      if (score[i] < tau) { ++i; continue; }
      int start = i;
      while (i < t && score[i] >= tau) ++i;
      const double on = timestamps[start];
      const double off = timestamps[i];
      const double dur = off - on;
      double inter_sum = 0.0;
      for (int j = 0; j < g; ++j) {
        const double inter = std::min(off, gts[2 * j + 1]) -
                             std::max(on, gts[2 * j]);
        if (inter > 0) inter_sum += inter;
      }
      const bool dtc_valid = dur > 0 && inter_sum / dur >= dtc;
      if (!dtc_valid) {
        ++fp;
        if (cttc > 0 && dur > 0) {
          for (int c = 0; c < n_other; ++c) {
            double os = 0.0;
            for (int j = other_offsets[c]; j < other_offsets[c + 1]; ++j) {
              const double inter = std::min(off, others[2 * j + 1]) -
                                   std::max(on, others[2 * j]);
              if (inter > 0) os += inter;
            }
            if (os / dur >= cttc) ++cts[c * t + ui];
          }
        }
        continue;
      }
      for (int j = 0; j < g; ++j) {
        const double inter = std::min(off, gts[2 * j + 1]) -
                             std::max(on, gts[2 * j]);
        if (inter > 0) coverage[j] += inter;
      }
    }
    for (int j = 0; j < g; ++j)
      if (gt_dur[j] > 0 && coverage[j] / gt_dur[j] >= gtc) ++tp;
    tps[ui] = tp;
    fps[ui] = fp;
  }
  return nu;
}

}  // extern "C"
