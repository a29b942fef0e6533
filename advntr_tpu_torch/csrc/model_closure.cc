// Native silent-state closure for the model compiler.
//
// Implements the three max-plus closure loops of
// advntr_tpu_torch/models/compiler.py::compile_graph (the transitive closure of
// every emitting state through the silent DAG, the start closure, and the
// effective emitting->emitting transition matrix) as flat-array C loops.
// The Python loops iterate ~n_s times over (n_e,) numpy vectors, paying
// interpreter + dispatch overhead per silent state; at panel scale (6,719
// loci x ~500 silent states) that overhead dominates cold model-bank
// construction.  Semantics are identical: strict > comparisons, first
// candidate wins ties, crossings accumulate along the argmax path.
//
// Reference semantics being compiled away: pomegranate's per-symbol silent
// passes, reference pomegranate/hmm.pyx:2044-2083.

#include <cstdint>
#include <cmath>

extern "C" {

// Closure of every emitting state (rows of C) plus the start state through
// the silent DAG, then the effective transition/start matrices.
//
// Arrays (row-major):
//   ss_count  (n_s+1)      CSR offsets of silent->silent in-edges per k
//   ss_src    (E)          source silent index of each in-edge
//   ss_w      (E)          log-weight of each in-edge
//   is_us/ue  (n_s)        unit_start / unit_end indicator
//   W_se      (n_s, n_e)   silent -> emitting direct edges
//   C         (n_e, n_s)   in: W_es direct edges; out: closure values
//   parent    (n_e, n_s)   in: -1 where W_es finite else INT32_MIN
//   cross_us  (n_e, n_s)   in: direct-edge crossings; out: closure crossings
//   cross_ue  (n_e, n_s)
//   C0,p0,c0_us,c0_ue (n_s) start closure (C0 pre-seeded at start_s)
//   log_T     (n_e, n_e)   in: W_ee; out: effective transitions
//   hop_choice(n_e, n_e)   in: -1 where W_ee finite else -2
//   t_us,t_ue (n_e, n_e)   out
//   log_start (n_e)        in: -inf; out
//   start_choice (n_e)     in: -2; out
//   s_us,s_ue (n_e)        out
void model_closure(
    int32_t n_e, int32_t n_s,
    const int32_t* ss_count, const int32_t* ss_src, const double* ss_w,
    const int8_t* is_us, const int8_t* is_ue,
    const double* W_se,
    double* C, int32_t* parent, int16_t* cross_us, int16_t* cross_ue,
    double* C0, int32_t* p0, int16_t* c0_us, int16_t* c0_ue,
    double* log_T, int32_t* hop_choice, int16_t* t_us, int16_t* t_ue,
    double* log_start, int32_t* start_choice, int16_t* s_us, int16_t* s_ue) {
  // ---- closure from every emitting state through the silent DAG (topo) ----
  for (int32_t k = 0; k < n_s; ++k) {
    const int8_t us_k = is_us[k], ue_k = is_ue[k];
    for (int32_t e = ss_count[k]; e < ss_count[k + 1]; ++e) {
      const int32_t src = ss_src[e];
      const double w = ss_w[e];
      if (w == -INFINITY) continue;
      for (int32_t i = 0; i < n_e; ++i) {
        const double cs = C[(int64_t)i * n_s + src];
        if (cs == -INFINITY) continue;
        const double cand = cs + w;
        const int64_t ik = (int64_t)i * n_s + k;
        if (cand > C[ik]) {
          C[ik] = cand;
          parent[ik] = src;
          cross_us[ik] = cross_us[(int64_t)i * n_s + src] + us_k;
          cross_ue[ik] = cross_ue[(int64_t)i * n_s + src] + ue_k;
        }
      }
      // start closure rides the same edge sweep
      if (C0[src] != -INFINITY) {
        const double cand0 = C0[src] + w;
        if (cand0 > C0[k]) {
          C0[k] = cand0;
          p0[k] = src;
          c0_us[k] = c0_us[src] + us_k;
          c0_ue[k] = c0_ue[src] + ue_k;
        }
      }
    }
  }

  // ---- effective transitions + start vector ------------------------------
  for (int32_t k = 0; k < n_s; ++k) {
    for (int32_t j = 0; j < n_e; ++j) {
      const double wse = W_se[(int64_t)k * n_e + j];
      if (wse == -INFINITY) continue;
      for (int32_t i = 0; i < n_e; ++i) {
        const double ck = C[(int64_t)i * n_s + k];
        if (ck == -INFINITY) continue;
        const double cand = ck + wse;
        const int64_t ij = (int64_t)i * n_e + j;
        if (cand > log_T[ij]) {
          log_T[ij] = cand;
          hop_choice[ij] = k;
          t_us[ij] = cross_us[(int64_t)i * n_s + k];
          t_ue[ij] = cross_ue[(int64_t)i * n_s + k];
        }
      }
      if (C0[k] != -INFINITY) {
        const double cand0 = C0[k] + wse;
        if (cand0 > log_start[j]) {
          log_start[j] = cand0;
          start_choice[j] = k;
          s_us[j] = c0_us[k];
          s_ue[j] = c0_ue[k];
        }
      }
    }
  }
}

}  // extern "C"
