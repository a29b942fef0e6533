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
//
// model_decode_closure computes only what the decode payload holds
// (models/decode_compiler.py::compile_decode), with the same semantics.

#include <cstdint>
#include <cmath>
#include <vector>

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

// The decode payload's part of model_closure (models/decode_compiler.py):
// the closure's column at END for each emitting state, the start closure
// and the start vector, from the edges in sparse form, with no (n_e x n_e)
// or (n_e x n_s) table.  The closure of row i through the silent DAG reads
// only row i, so each row is walked alone over one buffer of n_s values,
// in model_closure's topological order and edge order, with its strict >:
// the same values, the same ties, the same crossings along the argmax path.
// A row starts at its lowest direct silent target (nothing before it is
// reachable) and stops at END (what follows cannot reach it).
//
// Arrays:
//   es_count  (n_e+1)      CSR offsets of each emitting state's direct
//   es_dst    (E_es)       edges into the silent DAG: target, log-weight
//   es_w      (E_es)       (finite weights only)
//   ss_count, ss_src, ss_w as model_closure's
//   se_count  (n_s+1)      CSR offsets of each silent state's edges to
//   se_dst    (E_se)       emitting states, targets ascending, finite
//   se_w      (E_se)       weights only
//   is_us/ue  (n_s)
//   log_end,e_us,e_ue (n_e)       out: C[:, end_s] and its crossings
//   C0,p0,c0_us,c0_ue (n_s)       start closure (C0 pre-seeded at start_s)
//   log_start,start_choice,s_us,s_ue (n_e)   as model_closure's
void model_decode_closure(
    int32_t n_e, int32_t n_s, int32_t end_s,
    const int32_t* es_count, const int32_t* es_dst, const double* es_w,
    const int32_t* ss_count, const int32_t* ss_src, const double* ss_w,
    const int32_t* se_count, const int32_t* se_dst, const double* se_w,
    const int8_t* is_us, const int8_t* is_ue,
    double* log_end, int16_t* e_us, int16_t* e_ue,
    double* C0, int32_t* p0, int16_t* c0_us, int16_t* c0_ue,
    double* log_start, int32_t* start_choice, int16_t* s_us, int16_t* s_ue) {
  std::vector<double> c(n_s);
  std::vector<int16_t> cu(n_s), ce(n_s);
  for (int32_t i = 0; i < n_e; ++i) {
    int32_t lo = end_s + 1;
    for (int32_t e = es_count[i]; e < es_count[i + 1]; ++e)
      if (es_dst[e] < lo) lo = es_dst[e];
    log_end[i] = -INFINITY;
    e_us[i] = 0;
    e_ue[i] = 0;
    if (lo > end_s) continue;
    for (int32_t s = lo; s <= end_s; ++s) {
      c[s] = -INFINITY;
      cu[s] = 0;
      ce[s] = 0;
    }
    for (int32_t e = es_count[i]; e < es_count[i + 1]; ++e) {
      const int32_t s = es_dst[e];
      if (s > end_s) continue;
      c[s] = es_w[e];
      cu[s] = is_us[s];
      ce[s] = is_ue[s];
    }
    for (int32_t k = lo; k <= end_s; ++k) {
      const int8_t us_k = is_us[k], ue_k = is_ue[k];
      for (int32_t e = ss_count[k]; e < ss_count[k + 1]; ++e) {
        const int32_t src = ss_src[e];
        const double w = ss_w[e];
        if (src < lo || w == -INFINITY) continue;
        const double cs = c[src];
        if (cs == -INFINITY) continue;
        const double cand = cs + w;
        if (cand > c[k]) {
          c[k] = cand;
          cu[k] = cu[src] + us_k;
          ce[k] = ce[src] + ue_k;
        }
      }
    }
    log_end[i] = c[end_s];
    e_us[i] = cu[end_s];
    e_ue[i] = ce[end_s];
  }

  // ---- start closure, then the start vector over (k, j) ------------------
  for (int32_t k = 0; k < n_s; ++k) {
    const int8_t us_k = is_us[k], ue_k = is_ue[k];
    for (int32_t e = ss_count[k]; e < ss_count[k + 1]; ++e) {
      const int32_t src = ss_src[e];
      const double w = ss_w[e];
      if (w == -INFINITY || C0[src] == -INFINITY) continue;
      const double cand0 = C0[src] + w;
      if (cand0 > C0[k]) {
        C0[k] = cand0;
        p0[k] = src;
        c0_us[k] = c0_us[src] + us_k;
        c0_ue[k] = c0_ue[src] + ue_k;
      }
    }
  }
  for (int32_t k = 0; k < n_s; ++k) {
    if (C0[k] == -INFINITY) continue;
    for (int32_t e = se_count[k]; e < se_count[k + 1]; ++e) {
      const int32_t j = se_dst[e];
      const double cand0 = C0[k] + se_w[e];
      if (cand0 > log_start[j]) {
        log_start[j] = cand0;
        start_choice[j] = k;
        s_us[j] = c0_us[k];
        s_ue[j] = c0_ue[k];
      }
    }
  }
}

}  // extern "C"
