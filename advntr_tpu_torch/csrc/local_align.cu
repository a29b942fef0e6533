// Batched Smith-Waterman of one short probe against many long reads: the
// best local-alignment score of each read and the column where it ends.
//
// The reference has no TPU kernel here: advntr_tpu/ops/align.py::
// local_align_batch is a lax.scan over the read's columns that XLA fuses.
// The plain PyTorch version is advntr_tpu_torch/ops/align.py::
// local_align_batch_reference.  Eager PyTorch on the card would run that
// scan as a dozen small launches a column, some 600,000 launches for the
// two probes and two directions of one locus at 12 kb reads, so the scan
// is a kernel in the port.  All arithmetic is int32 (match +1, mismatch
// -1, linear gap -1), so the kernel and the plain version agree exactly.
//
// What bounds it on an H100: the chain.  A read's columns are serial and
// each costs a handful of shuffles; the bytes (one per read and column)
// and the operations (about a dozen per probe position and column) are
// far below what the card moves and computes in that time.  The design
// keeps the whole row in registers: one warp per read, the probe's <= 128
// positions four to a lane, the row H[t, .] as four registers a lane.
// A column takes one shuffle for the diagonal neighbour, the left-gap
// chain as a running maximum with linear decay (a prefix max inside the
// lane, then five shuffle steps across lanes), and one warp reduction for
// the row maximum.  The read's bases are loaded 32 columns at a time, one
// byte a lane, and handed round by shuffle.  Rows at and past a read's
// length are never computed: they leave H, the score and the end alone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PER_LANE = 4;            // probe positions a lane
constexpr int MAX_PROBE = 32 * PER_LANE;
constexpr int WARPS_PER_CTA = 4;
constexpr int LOW = -(1 << 29);        // below every cand + position
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(32 * WARPS_PER_CTA)
local_align_kernel(const int8_t* __restrict__ reads,      // (B, L)
                   const int32_t* __restrict__ lengths,   // (B,)
                   const int8_t* __restrict__ probe,      // (m,)
                   int32_t* __restrict__ score,           // (B,)
                   int32_t* __restrict__ end,             // (B,)
                   int B, int L, int m) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS_PER_CTA + (threadIdx.x >> 5);
  if (b >= B) return;
  int pr[PER_LANE], T[PER_LANE];       // the probe, and H[t-1, q+1]
#pragma unroll
  for (int u = 0; u < PER_LANE; ++u) {
    const int q = lane * PER_LANE + u;
    pr[u] = q < m ? (int)probe[q] : -128;
    T[u] = 0;
  }
  const int n = min(max(lengths[b], 0), L);
  const int8_t* row = reads + (size_t)b * L;
  int best = 0, best_end = 0;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int chunk = c0 + lane < n ? (int)row[c0 + lane] : 0;
    const int cols = min(32, n - c0);
    for (int tt = 0; tt < cols; ++tt) {
      const int base = __shfl_sync(FULL, chunk, tt);
      // H[t-1, q] of this lane's first position: the lane below's last
      int diag_in = __shfl_up_sync(FULL, T[PER_LANE - 1], 1);
      if (lane == 0) diag_in = 0;      // H[., 0] = 0
      int x[PER_LANE];
      int run = LOW;
#pragma unroll
      for (int u = 0; u < PER_LANE; ++u) {
        const int q = lane * PER_LANE + u;
        const int diag = diag_in + (pr[u] == base ? 1 : -1);
        const int cand = max(max(diag, T[u] - 1), 0);
        diag_in = T[u];
        run = max(run, q < m ? cand + q : LOW);
        x[u] = run;                    // prefix max inside the lane
      }
      // prefix max of the lanes below
      int incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl = max(incl, y);
      }
      int excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = LOW;
      int mx = 0;
#pragma unroll
      for (int u = 0; u < PER_LANE; ++u) {
        const int q = lane * PER_LANE + u;
        const int h = max(x[u], excl) - q;
        T[u] = q < m ? h : 0;
        if (q < m) mx = max(mx, h);
      }
      mx = __reduce_max_sync(FULL, mx);
      // only a strictly better row moves the end
      if (mx > best) { best = mx; best_end = c0 + tt + 1; }
    }
  }
  if (lane == 0) { score[b] = best; end[b] = best_end; }
}

}  // namespace

extern "C" {

// Launches the batched local alignment on `stream`; returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for a probe
// longer than a warp holds.
int advntr_local_align(const void* reads, const void* lengths,
                       const void* probe, void* score, void* end, int B,
                       int L, int m, void* stream) {
  if (m < 1 || m > MAX_PROBE) return (int)cudaErrorInvalidValue;
  const int threads = 32 * WARPS_PER_CTA;
  const int blocks = (B + WARPS_PER_CTA - 1) / WARPS_PER_CTA;
  local_align_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)reads, (const int32_t*)lengths, (const int8_t*)probe,
      (int32_t*)score, (int32_t*)end, B, L, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
