// Sparse-graph Viterbi with silent states — CPU engine.
//
// Implements the same recurrence the reference's Cython kernel runs
// (pomegranate/hmm.pyx:2002-2130): states ordered emitting-first then
// silent-topological; per symbol three passes (emitting from previous
// column; silent fed by current-column emitting; silent fed by
// lower-topo silent), then traceback from the end state.
//
// Used as (a) the honest CPU baseline for the TPU benchmark and (b) a
// host-side fallback engine.  Built with: g++ -O3 -shared -fPIC.

#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {
constexpr double NEG_INF = -std::numeric_limits<double>::infinity();
}

extern "C" {

// Returns 0 on success, -1 if the sequence has no path to the end state.
// path must have room for n + n_states entries; *path_len receives the
// number of states on the full path (including silent states).
int viterbi_sparse(
    int n_states, int silent_start,
    const int32_t* in_edge_count,      // (n_states+1,) CSR offsets
    const int32_t* in_transitions,     // (E,) source state per in-edge
    const double* in_logw,             // (E,) log weight per in-edge
    const double* log_e,               // (silent_start*4) emissions
    int start_index, int end_index,
    const int8_t* seq, int n,
    double* out_logp, int32_t* out_path, int32_t* out_path_len) {
  const int m = n_states;
  std::vector<double> v((size_t)(n + 1) * m, NEG_INF);
  std::vector<int32_t> tbx((size_t)(n + 1) * m, 0);
  std::vector<int32_t> tby((size_t)(n + 1) * m, -1);

  v[start_index] = 0.0;
  for (int l = silent_start; l < m; ++l) {
    if (l == start_index) continue;
    for (int k = in_edge_count[l]; k < in_edge_count[l + 1]; ++k) {
      int ki = in_transitions[k];
      if (ki < silent_start || ki >= l) continue;
      double cand = v[ki] + in_logw[k];
      if (cand > v[l]) {
        v[l] = cand;
        tbx[l] = 0;
        tby[l] = ki;
      }
    }
  }

  for (int i = 0; i < n; ++i) {
    double* vp = v.data() + (size_t)i * m;
    double* vc = v.data() + (size_t)(i + 1) * m;
    int32_t* tx = tbx.data() + (size_t)(i + 1) * m;
    int32_t* ty = tby.data() + (size_t)(i + 1) * m;
    const int8_t base = seq[i];
    for (int l = 0; l < silent_start; ++l) {
      const double e = log_e[(size_t)l * 4 + base];
      double best = NEG_INF;
      int bk = -1;
      for (int k = in_edge_count[l]; k < in_edge_count[l + 1]; ++k) {
        double cand = vp[in_transitions[k]] + in_logw[k];
        if (cand > best) {
          best = cand;
          bk = in_transitions[k];
        }
      }
      if (bk >= 0) {
        vc[l] = best + e;
        tx[l] = i;
        ty[l] = bk;
      }
    }
    for (int l = silent_start; l < m; ++l) {
      for (int k = in_edge_count[l]; k < in_edge_count[l + 1]; ++k) {
        int ki = in_transitions[k];
        if (ki >= silent_start) continue;
        double cand = vc[ki] + in_logw[k];
        if (cand > vc[l]) {
          vc[l] = cand;
          tx[l] = i + 1;
          ty[l] = ki;
        }
      }
    }
    for (int l = silent_start; l < m; ++l) {
      for (int k = in_edge_count[l]; k < in_edge_count[l + 1]; ++k) {
        int ki = in_transitions[k];
        if (ki < silent_start || ki >= l) continue;
        double cand = vc[ki] + in_logw[k];
        if (cand > vc[l]) {
          vc[l] = cand;
          tx[l] = i + 1;
          ty[l] = ki;
        }
      }
    }
  }

  double logp = v[(size_t)n * m + end_index];
  *out_logp = logp;
  if (logp == NEG_INF) {
    *out_path_len = 0;
    return -1;
  }
  int px = n, py = end_index;
  int length = 0;
  while (px != 0 || py != start_index) {
    out_path[length++] = py;
    int npx = tbx[(size_t)px * m + py];
    py = tby[(size_t)px * m + py];
    px = npx;
  }
  out_path[length++] = py;
  for (int i = 0; i < length / 2; ++i) {
    int32_t t = out_path[i];
    out_path[i] = out_path[length - 1 - i];
    out_path[length - 1 - i] = t;
  }
  *out_path_len = length;
  return 0;
}

}  // extern "C"
