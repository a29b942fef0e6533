// B2: backward origin walk with the per-read genotyping statistics.
//
// Replaces the TPU kernel built by
// advntr_tpu/ops/pallas_viterbi.py::_make_backward_kernel (launched by
// pallas_backward_stats).  The plain PyTorch twin is
// advntr_tpu_torch/ops/viterbi_fused.py::backward_stats_reference; both give
// bit-identical paths and statistics on the same planes.
//
// What bounds it on an H100: dependent loads.  Each column's origin lookup
// needs the state found one column later, so a read's walk is a chain of L
// dependent loads from device memory (a few hundred cycles each) with a
// handful of integer ops between them.  The design: one thread per read,
// one indexed load per column (the TPU resolved the origin with a masked
// row-sum over all 2P lanes, because lane gathers are slow there), the
// twelve statistics in registers, and enough reads in flight (B=4096 is
// 4096 independent chains) to hide the load latency.  The plane rows of
// neighbouring reads are neighbours in memory, so the loads of one warp
// fall in a few 2P-wide rows.  A group of G same-shape loci is one launch,
// grid (ceil(B / 128), G), each locus with its own planes and state tables.
//
// Its bound.  The bytes are one origin code read and one path entry
// written per read and column plus the statistics, about 4 MB at B=4096,
// L=160: a microsecond at 3.35 TB/s.  The chain sets the time instead: L
// dependent loads a read, each a trip to L2 or device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 30;
constexpr int MIN_BP_IN_REPEAT = 3;
constexpr int N_STATS = 16;
// region codes of advntr_tpu_torch/models/graph.py
constexpr int R_SUFFIX = 0, R_REPEAT = 1, R_PREFIX = 2;

struct BwdArgs {
  const int32_t* lengths;   // (G, B)
  const int32_t* bstate;    // (G, B)
  const void* oMI;          // (G, L, B, 2P)
  const void* oXH;          // (G, L, B, 2nb)
  const int32_t* region;    // (G, n_struct)
  const int32_t* unit;      // (G, n_struct)
  int32_t* path;            // (G, B, L)
  int32_t* stats;           // (G, B, N_STATS)
  int B, L, P, nb, n_struct, mbit;
};

template <typename OT>
__global__ void viterbi_backward_kernel(const BwdArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int g = blockIdx.y;
  const int P2 = 2 * a.P, nb2 = 2 * a.nb, L = a.L;
  const int code_mask = a.mbit - 1;
  const OT* oMI = (const OT*)a.oMI + (size_t)g * L * a.B * P2;
  const OT* oXH = (const OT*)a.oXH + (size_t)g * L * a.B * nb2;
  const int32_t* region_t = a.region + (size_t)g * a.n_struct;
  const int32_t* unit_t = a.unit + (size_t)g * a.n_struct;
  const size_t read = (size_t)g * a.B + b;
  int32_t* path = a.path + read * L;
  const int len = a.lengths[read];
  int cur = a.bstate[read];
  int rnext = 0, unext = 0;
  int nm = 0, repbp = 0, lbp = 0, rbp = 0, lmt = 0, rmt = 0;
  int starts = 0, ends = 0, fs = BIG, ls = -BIG, fe = BIG, le = -BIG;

  for (int t = L - 1; t >= 0; --t) {
    path[t] = cur;
    const size_t row = (size_t)t * a.B + b;
    const OT* rMI = oMI + row * P2;
    const OT* rXH = oXH + row * nb2;
    // an index outside the row reads 0, as the reference's masked sum does
    int sel;
    if (cur < P2) sel = cur >= 0 ? (int)rMI[cur] : 0;
    else sel = cur - P2 < nb2 ? (int)rXH[cur - P2] : 0;
    const bool m_bit = sel >= a.mbit;
    int prev = (sel & code_mask) - 1;
    if (prev >= P2 + a.nb)                  // hub sentinel: resolve it
      prev = (prev - P2 < nb2 ? (int)rXH[prev - P2] : 0) - 1;
    const bool in_meta = cur >= 0 && cur < a.n_struct;
    const int region = in_meta ? region_t[cur] : 0;
    const int unit = in_meta ? unit_t[cur] : -1;

    const bool valid = t < len;
    const bool is_m = cur < a.P && valid;
    const bool in_suf = region == R_SUFFIX, in_rep = region == R_REPEAT,
               in_pre = region == R_PREFIX;
    nm += is_m;
    repbp += in_rep && valid;
    lbp += in_suf && valid;
    rbp += in_pre && valid;
    const bool bm = is_m && m_bit;
    lmt += bm && in_suf;
    rmt += bm && in_pre;

    // end hop (bp = length, applied at column length-1)
    if (t == len - 1 && len >= MIN_BP_IN_REPEAT &&
        ((in_rep && cur >= a.P) || in_suf)) {
      ends += 1;
      fe = min(fe, len);
      le = max(le, len);
    }

    // hop h = t+1 (path[t] -> path[t+1])
    const int h = t + 1;
    const int base = in_rep ? unit : -1;
    const int sr = unext - base;
    const int er = sr - (int)in_suf;
    const bool nrep = rnext == R_REPEAT, npre = rnext == R_PREFIX;
    const int hop_us = max(nrep ? sr : (int)(npre && in_suf), 0);
    const int hop_ue = max(nrep ? er : (int)(npre && (in_rep || in_suf)), 0);
    const bool hop_ok = h < len;
    const int cs = hop_ok && len - h >= MIN_BP_IN_REPEAT ? hop_us : 0;
    const int ce = hop_ok && h >= MIN_BP_IN_REPEAT ? hop_ue : 0;
    starts += cs;
    ends += ce;
    if (cs > 0) { fs = min(fs, h); ls = max(ls, h); }
    if (ce > 0) { fe = min(fe, h); le = max(le, h); }

    // start hop (hop 0, at column 0): only the starts side contributes
    if (t == 0 && len >= MIN_BP_IN_REPEAT) {
      const bool j0u0m = in_rep && unit == 0 && cur < a.P;
      const int cs0 = in_rep && !j0u0m ? unit + 1 : (int)in_pre;
      starts += cs0;
      if (cs0 > 0) { fs = min(fs, 0); ls = max(ls, 0); }
    }

    rnext = region;
    unext = unit;
    if (t <= len - 1 && t >= 1) cur = prev;
  }

  int32_t* s = a.stats + read * N_STATS;
  s[0] = nm; s[1] = repbp; s[2] = lbp; s[3] = rbp; s[4] = lmt; s[5] = rmt;
  s[6] = starts; s[7] = ends; s[8] = fs; s[9] = ls; s[10] = fe; s[11] = le;
  for (int k = 12; k < N_STATS; ++k) s[k] = 0;
}

}  // namespace

extern "C" {

// Launches B2 for G loci on `stream`; returns cudaGetLastError() of the
// launch.
int advntr_viterbi_backward(
    const void* lengths, const void* bstate, const void* oMI, const void* oXH,
    const void* region, const void* unit, void* path, void* stats, int G,
    int B, int L, int P, int nb, int n_struct, int origin32, int mbit,
    void* stream) {
  BwdArgs a;
  a.lengths = (const int32_t*)lengths; a.bstate = (const int32_t*)bstate;
  a.oMI = oMI; a.oXH = oXH;
  a.region = (const int32_t*)region; a.unit = (const int32_t*)unit;
  a.path = (int32_t*)path; a.stats = (int32_t*)stats;
  a.B = B; a.L = L; a.P = P; a.nb = nb; a.n_struct = n_struct;
  a.mbit = mbit;
  const int threads = 128;
  const dim3 blocks((B + threads - 1) / threads, G);
  cudaStream_t s = (cudaStream_t)stream;
  if (origin32)
    viterbi_backward_kernel<int32_t><<<blocks, threads, 0, s>>>(a);
  else
    viterbi_backward_kernel<int16_t><<<blocks, threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
