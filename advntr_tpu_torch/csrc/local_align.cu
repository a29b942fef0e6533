// Batched Smith-Waterman of short probes against many long reads: the best
// local-alignment score of each (probe, read) and the row where it ends.
//
// The reference has no TPU kernel here: advntr_tpu/ops/align.py::
// local_align_batch is a lax.scan over the read's rows that XLA fuses.
// The plain PyTorch version is advntr_tpu_torch/ops/align.py::
// local_align_batch_reference, and the scheme below in plain PyTorch is
// local_align_wavefront_reference beside it.  All arithmetic is int32
// (match +1, mismatch -1, linear gap -1), so they agree exactly.
//
// What bounds it on an H100: the chain.  Row t of H needs row t - 1, and
// inside a row each probe position needs the one before it (the left
// gap); the bytes (one a read row) and the operations (a handful a cell)
// are far below what the card moves and computes in that time.  The
// design takes the chain apart three ways.
//
// A wavefront over the probe.  A warp holds the probe's <= 128 positions,
// four to a lane: lane k holds positions 4k..4k+3 and at step s computes
// row t = s - k.  The row's left neighbour H[t, 4k] is lane k-1's last
// value of row t, computed at step s - 1, and the diagonal H[t-1, 4k] is
// the one it handed on the step before, so one shuffle a step carries the
// chain down the lanes.  There is no scan across lanes and no reduction
// per row: a chunk of n rows takes n + 31 steps (fewer for a short probe,
// whose upper lanes sit out).  The read's bases wait in a 64-row ring in
// shared memory, loaded 32 rows a time one block of steps ahead, so a
// lane's base is off the chain.  The step has no branch: a lane before its
// first row reads a base that matches nothing and keeps H = 0, a lane past
// its last row or past the probe computes what nothing reads, and only
// rows the lane counts move its best.
//
// The best and the end, reduced once.  Each lane keeps its own maximum and
// the first row at which it reached it (strict >).  At the end the best is
// the maximum over the lanes and the end is 1 + the smallest first row
// among the lanes that hold it: the first row whose row maximum equals the
// final best, which is the reference's rule (the end moves on a strictly
// better row maximum).  Cells past the probe's end (the last lane of a
// probe whose length is not a multiple of 4) take part without harm:
// their values come from the probe's own cells less at least one, so they
// never reach a best that those cells have not reached first.
//
// Overlapping chunks of a read, to fill the card.  An alignment of
// positive score spans fewer than 2m read rows (m probe positions: at most
// m matches and mismatches, so r rows carry at least r - m read gaps and
// score at most 2m - r).  So a chunk that starts from H = 0 at row
// i0 - 2m has the exact H from row i0 on.  Each read is split into chunks
// of `rows` rows, a warp each, with 2m warm-up rows that count toward
// neither the best nor the end; the chunks combine by a 64-bit atomic max
// of (best, ~end) (the larger best, then the earlier end), and the last
// chunk of a (probe, read) to finish writes its score and end.
//
// One launch takes several passes (grid y): probes of up to 128 bases,
// each against one of R read batches (the flanks against the reads, the
// reversed flanks against the reversed reads).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PER_LANE = 4;            // probe positions a lane
constexpr int MAX_PROBE = 32 * PER_LANE;
constexpr int MAX_PASSES = 8;          // (probe, read batch) pairs a launch
constexpr int WARPS_PER_CTA = 4;
constexpr unsigned FULL = 0xffffffffu;

struct AlignArgs {
  const int8_t* reads;                 // (R, B, L)
  const int32_t* lengths;              // (B,)
  const int8_t* probes;                // (Q, stride)
  int32_t* score;                      // (Q, B)
  int32_t* end;                        // (Q, B)
  unsigned long long* key;             // (Q, B), zero: the chunks' max
  unsigned long long* done;            // (Q, B), zero: chunks finished
  int B, L, stride, chunks, rows;
  int probe_len[MAX_PASSES];
  int read_set[MAX_PASSES];
};

__global__ void __launch_bounds__(32 * WARPS_PER_CTA)
local_align_kernel(const AlignArgs a) {
  // each warp's read bases, by row & 63: the 32 rows of this block of
  // steps and the 32 before, which the upper lanes are still on
  __shared__ int8_t ring[WARPS_PER_CTA][64];
  const int lane = threadIdx.x & 31;
  const int wi = threadIdx.x >> 5;
  const int w = blockIdx.x * WARPS_PER_CTA + wi;
  const int pass = blockIdx.y;
  const int b = w / a.chunks, c = w - b * a.chunks;
  if (b >= a.B) return;
  const int m = a.probe_len[pass];
  const int n = min(max(a.lengths[b], 0), a.L);
  const int c0 = c * a.rows;           // the chunk's first counted row
  const int e = min(c0 + a.rows, n);   // its end
  const int r0 = max(c0 - 2 * m, 0);   // its first row, warm-up included
  int best = 0, first = 0;
  if (c0 < e) {
    const int8_t* row =
        a.reads + ((size_t)a.read_set[pass] * a.B + b) * a.L;
    const int8_t* probe = a.probes + (size_t)pass * a.stride;
    int pr[PER_LANE], T[PER_LANE];     // the probe, and H[t-1, 4k+u+1]
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      const int q = lane * PER_LANE + u;
      pr[u] = q < m ? (int)probe[q] : -128;
      T[u] = 0;
    }
    const int nl = (m + PER_LANE - 1) / PER_LANE;   // lanes in use
    // the rows a lane counts, c0 <= t < e: none past the probe
    const unsigned span = lane < nl ? (unsigned)(e - c0) : 0u;
    int8_t* rg = ring[wi];
    // rows before r0 hold a base that matches nothing: a lane runs the
    // same instructions before its first row and keeps H = 0 there
    rg[(r0 + 32 + lane) & 63] = -1;
    int dgl = 0;                       // H[t-1, 4k]
    int out = 0;                       // H[t, 4k+4], handed to lane k+1
    const int steps = e - r0 + nl - 1;
    int next = r0 + lane < e ? (int)row[r0 + lane] : -1;
    for (int s0 = 0; s0 < steps; s0 += 32) {
      __syncwarp();
      rg[(r0 + s0 + lane) & 63] = (int8_t)next;
      __syncwarp();
      const int rt = r0 + s0 + 32 + lane;   // the next block's, in flight
      next = rt < e ? (int)row[rt] : -1;
      const int tb = r0 + s0 - lane;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (s0 + i >= steps) break;
        const int t = tb + i;          // this lane's row
        const int base = (int)rg[t & 63];
        const int v = __shfl_up_sync(FULL, out, 1);
        int hl = lane == 0 ? 0 : v, dg = dgl, mx = 0;
        dgl = hl;
#pragma unroll
        for (int u = 0; u < PER_LANE; ++u) {
          // max(up - 1, diagonal + substitution, 0), then the left gap
          const int cnd = __viaddmax_s32_relu(
              T[u], -1, pr[u] == base ? dg + 1 : dg - 1);
          dg = T[u];
          hl = __viaddmax_s32(hl, -1, cnd);
          T[u] = hl;
          mx = max(mx, hl);
        }
        out = hl;
        if ((unsigned)(t - c0) < span && mx > best) { best = mx; first = t; }
      }
    }
  }
  // the chunk's best and the first row that reached it
  const int cb = __reduce_max_sync(FULL, best);
  const unsigned cf = __reduce_min_sync(
      FULL, best == cb ? (unsigned)first : 0xffffffffu);
  if (lane == 0) {
    const unsigned ce = cb > 0 ? cf + 1 : 0;
    const size_t at = (size_t)pass * a.B + b;
    atomicMax(a.key + at,
              ((unsigned long long)cb << 32) | (0xffffffffu - ce));
    __threadfence();
    if (atomicAdd(a.done + at, 1ull) == (unsigned long long)a.chunks - 1) {
      __threadfence();
      // every chunk of this (probe, read) is in: the larger best, then the
      // earlier end
      const unsigned long long k = atomicMax(a.key + at, 0ull);
      a.score[at] = (int)(k >> 32);
      a.end[at] = (int)(0xffffffffu - (unsigned)(k & 0xffffffffu));
    }
  }
}

}  // namespace

extern "C" {

// Launches the batched local alignment on `stream`: Q passes, pass i
// aligning the probe of probe_len[i] bases at probes + i * stride against
// read batch read_set[i] of reads (R, B, L), each read in `chunks` chunks
// of `rows` rows; `work` is 2 * Q * B zeroed 64-bit words.  Returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for a shape
// it does not take.
int advntr_local_align(const void* reads, const void* lengths,
                       const void* probes, const int* probe_len,
                       const int* read_set, void* score, void* end,
                       void* work, int R, int B, int L, int Q, int stride,
                       int chunks, int rows, void* stream) {
  if (Q < 1 || Q > MAX_PASSES || B < 1 || L < 1 || chunks < 1 ||
      rows < 1 || (long long)chunks * rows < L ||
      (long long)B * chunks > 0x7fffffffLL - WARPS_PER_CTA)
    return (int)cudaErrorInvalidValue;
  AlignArgs a;
  for (int i = 0; i < Q; ++i) {
    if (probe_len[i] < 1 || probe_len[i] > MAX_PROBE ||
        probe_len[i] > stride || read_set[i] < 0 || read_set[i] >= R)
      return (int)cudaErrorInvalidValue;
    a.probe_len[i] = probe_len[i];
    a.read_set[i] = read_set[i];
  }
  a.reads = (const int8_t*)reads;
  a.lengths = (const int32_t*)lengths;
  a.probes = (const int8_t*)probes;
  a.score = (int32_t*)score;
  a.end = (int32_t*)end;
  a.key = (unsigned long long*)work;
  a.done = a.key + (size_t)Q * B;
  a.B = B; a.L = L; a.stride = stride; a.chunks = chunks; a.rows = rows;
  const long long warps = (long long)B * chunks;
  const dim3 grid((unsigned)((warps + WARPS_PER_CTA - 1) / WARPS_PER_CTA),
                  (unsigned)Q);
  local_align_kernel<<<grid, 32 * WARPS_PER_CTA, 0, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}

}  // extern "C"
