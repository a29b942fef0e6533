// B2: backward origin walk with the per-read genotyping statistics.
//
// Replaces the TPU kernel built by
// advntr_tpu/ops/pallas_viterbi.py::_make_backward_kernel (launched by
// pallas_backward_stats).  The plain PyTorch twin is
// advntr_tpu_torch/ops/viterbi_fused.py::backward_stats_reference; both give
// bit-identical paths and statistics on the same planes.
// backward_stats_windowed_reference in the same module is this kernel's
// scheme, step by step, in plain PyTorch.
//
// What bounds it on an H100: memory trips, not bytes or operations.  The
// walk uses one 2-byte origin code per read and column (1.2 MB at B=4096,
// L=160, under a microsecond at 3.35 TB/s), but the code of column t names
// the state of column t-1, so a walk that looks one column up at a time is
// a chain of L trips to device memory, about a microsecond each.  And every
// code lies alone in its 32-byte sector, in a plane row of its own, so even
// with all loads in flight the card serves scattered sectors, not a stream.
//
// The design cuts the trips.  A Viterbi path can be guessed almost
// everywhere.  A read that follows the model runs down the diagonal: M_p at
// column t comes from M_p-1 at column t-1, across unit boundaries too,
// where the hub sentinel resolves to the last state of the unit before.  A
// read that does not (half of a panel's rows are wrong-strand candidates)
// sits in the self-loop of one insert state.  So a warp takes one read,
// lane i assumes state cur-i at column t-i where cur is a match state and
// cur itself where it is an insert state, and all lanes load their origin
// codes (and resolve a hub sentinel with a second load) side by side: one
// trip for 32 columns.  A vote finds the first lane whose origin is not the
// next lane's assumed state; the lanes up to it hold true columns of the
// path and add their statistics, and its origin is where the next window
// starts.  A window always keeps its first lane, so the worst case is one
// column a trip and the result never depends on the guess.  Columns at and
// past a read's end hold the end state and are never loaded.  The
// statistics are integer sums, minima and maxima, kept per lane and reduced
// once at the end, so their order does not matter.  The region and unit of
// every state sit packed in shared memory, staged once a CTA.  The path is
// written (one descending run of columns a window) only when asked for.
// A group of G same-shape loci is one launch, grid (ceil(B / 8), G), each
// locus with its own planes and state table.
//
// Segments.  The planes may hold only the columns t0 .. t0 + L - 1 of the
// reads (the checkpointed traceback, ops/viterbi_ckpt.py, has one segment's
// planes at a time).  The walk then enters with the state each read stands
// in at the range's last column, stops its windows at column t0, writes
// these columns' slice of the path and leaves the state above column t0.
// A read that ends before the range does nothing in it; one that ends in
// it starts from its end state.  The statistics count the columns walked,
// so they are a read's own only where the range is the whole read.
// A model of more than MAX_STRUCT states (a long-read model) does not
// stage its state table: region and unit are read from device memory.
//
// TMA, wgmma and thread block clusters have nothing to carry here: the
// kernel uses 2 bytes per read and column at addresses that the data
// decide, and does no matrix arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 30;
constexpr int MIN_BP_IN_REPEAT = 3;
constexpr int N_STATS = 16;
// region codes of advntr_tpu_torch/models/graph.py
constexpr int R_SUFFIX = 0, R_REPEAT = 1, R_PREFIX = 2;
constexpr int WINDOW = 32;           // columns a window: a warp a read
constexpr int WARPS_PER_CTA = 8;     // reads a CTA
constexpr int MAX_STRUCT = 12288;    // state table entries in 48 KB
constexpr unsigned FULL = 0xffffffffu;

struct BwdArgs {
  const int32_t* lengths;   // (G, B)
  const int32_t* bstate;    // (G, B)
  const void* oMI;          // (G, L, B, 2P)
  const void* oXH;          // (G, L, B, 2nb)
  const int32_t* region;    // (G, n_struct)
  const int32_t* unit;      // (G, n_struct)
  int32_t* path;            // (G, B, L), null unless the path is asked for
  int32_t* stats;           // (G, B, N_STATS)
  const int32_t* entry;     // (G, B) state at column t0 + L - 1, or null
  int32_t* exit_state;      // (G, B) state above column t0, or null
  int B, L, P, nb, n_struct, mbit;
  int t0;                   // the read column of the planes' first row
};

template <typename OT, bool WRITE_PATH, bool STAGED>
__global__ void __launch_bounds__(32 * WARPS_PER_CTA)
viterbi_backward_kernel(const BwdArgs a) {
  // (unit << 2) | region of every struct state of this CTA's locus
  extern __shared__ int32_t meta[];
  const int g = blockIdx.y;
  const int32_t* region_t = a.region + (size_t)g * a.n_struct;
  const int32_t* unit_t = a.unit + (size_t)g * a.n_struct;
  if (STAGED) {
    for (int k = threadIdx.x; k < a.n_struct; k += blockDim.x)
      meta[k] = unit_t[k] * 4 + (region_t[k] & 3);
    __syncthreads();
  }

  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS_PER_CTA + (threadIdx.x >> 5);
  if (b >= a.B) return;                 // whole warps, after the barrier
  const int P2 = 2 * a.P, nb2 = 2 * a.nb, L = a.L;
  const int code_mask = a.mbit - 1;
  const OT* oMI = (const OT*)a.oMI + (size_t)g * L * a.B * P2;
  const OT* oXH = (const OT*)a.oXH + (size_t)g * L * a.B * nb2;
  const size_t read = (size_t)g * a.B + b;
  const int len = a.lengths[read];
  const int bstate = a.bstate[read];
  int32_t* path = WRITE_PATH ? a.path + read * L : nullptr;

  // the walk starts at the read's last column, or at the range's where
  // the read goes on past it; later columns hold the end state, count
  // nothing and are never looked up
  const int t0 = a.t0, t_end = t0 + L;
  int t = min(len, t_end) - 1;
  int cur = a.entry ? a.entry[read] : bstate;
  if (WRITE_PATH)
    for (int c = max(t + 1, t0) + lane; c < t_end; c += WINDOW)
      path[c - t0] = bstate;

  int rcarry = 0, ucarry = 0;         // region and unit of column t+1
  int nm = 0, repbp = 0, lbp = 0, rbp = 0, lmt = 0, rmt = 0;
  int starts = 0, ends = 0, fs = BIG, ls = -BIG, fe = BIG, le = -BIG;

  while (t >= t0) {                     // t and cur are the warp's
    // lane i assumes a state at column t-i: cur-i down the diagonal from a
    // match state, cur itself in the self-loop of an insert state
    const int step = cur < a.P ? 1 : 0;
    const bool in_model = cur >= 0 && cur < a.n_struct;
    const int c = t - lane, s = cur - lane * step;
    const bool active = c >= t0 && (lane == 0 || (in_model && s >= 0));
    int sel = 0, prev = -1;
    if (active) {
      const size_t row = (size_t)(c - t0) * a.B + b;
      const OT* rXH = oXH + row * nb2;
      // an index outside the row reads 0, as the reference's masked sum does
      if (s < P2) sel = s >= 0 ? (int)oMI[row * P2 + s] : 0;
      else sel = s - P2 < nb2 ? (int)rXH[s - P2] : 0;
      prev = (sel & code_mask) - 1;
      if (prev >= P2 + a.nb)                // hub sentinel: resolve it
        prev = (prev - P2 < nb2 ? (int)rXH[prev - P2] : 0) - 1;
    }
    const bool m_bit = sel >= a.mbit;
    // lane i confirms lane i+1 where the walk moves on from its column to
    // the state that lane assumed, inside the range; lanes 0..j hold true
    // columns
    const bool ok = active && lane < WINDOW - 1 && c >= 1 && c > t0 &&
                    in_model && s >= step && prev == s - step;
    const int j = __ffs(~__ballot_sync(FULL, ok)) - 1;

    int packed = -4;
    if (s >= 0 && s < a.n_struct)
      packed = STAGED ? meta[s] : unit_t[s] * 4 + (region_t[s] & 3);
    const int region = packed & 3, unit = packed >> 2;
    int rnext = __shfl_up_sync(FULL, region, 1);
    int unext = __shfl_up_sync(FULL, unit, 1);
    if (lane == 0) { rnext = rcarry; unext = ucarry; }

    if (active && lane <= j) {
      if (WRITE_PATH) path[c - t0] = s;
      const bool valid = c < len;
      const bool is_m = s < a.P && valid;
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
      if (c == len - 1 && len >= MIN_BP_IN_REPEAT &&
          ((in_rep && s >= a.P) || in_suf)) {
        ends += 1;
        fe = min(fe, len);
        le = max(le, len);
      }

      // hop h = c+1 (path[c] -> path[c+1])
      const int h = c + 1;
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
      if (c == 0 && len >= MIN_BP_IN_REPEAT) {
        const bool j0u0m = in_rep && unit == 0 && s < a.P;
        const int cs0 = in_rep && !j0u0m ? unit + 1 : (int)in_pre;
        starts += cs0;
        if (cs0 > 0) { fs = min(fs, 0); ls = max(ls, 0); }
      }
    }

    // lane j hands the walk on: its origin is the next window's state
    const int prev_j = __shfl_sync(FULL, prev, j);
    rcarry = __shfl_sync(FULL, region, j);
    ucarry = __shfl_sync(FULL, unit, j);
    if (t - j >= 1) cur = prev_j;
    else if (a.exit_state) cur = __shfl_sync(FULL, s, j);  // column 0's
    t -= j + 1;
  }
  if (a.exit_state && lane == 0) a.exit_state[read] = cur;

  nm = __reduce_add_sync(FULL, nm);
  repbp = __reduce_add_sync(FULL, repbp);
  lbp = __reduce_add_sync(FULL, lbp);
  rbp = __reduce_add_sync(FULL, rbp);
  lmt = __reduce_add_sync(FULL, lmt);
  rmt = __reduce_add_sync(FULL, rmt);
  starts = __reduce_add_sync(FULL, starts);
  ends = __reduce_add_sync(FULL, ends);
  fs = __reduce_min_sync(FULL, fs);
  ls = __reduce_max_sync(FULL, ls);
  fe = __reduce_min_sync(FULL, fe);
  le = __reduce_max_sync(FULL, le);
  if (lane == 0) {
    int4* s4 = (int4*)(a.stats + read * N_STATS);
    s4[0] = make_int4(nm, repbp, lbp, rbp);
    s4[1] = make_int4(lmt, rmt, starts, ends);
    s4[2] = make_int4(fs, ls, fe, le);
    s4[3] = make_int4(0, 0, 0, 0);
  }
}

}  // namespace

extern "C" {

// Launches B2 for G loci on `stream` over planes that hold the columns
// t0 .. t0 + L - 1; returns cudaGetLastError() of the launch.  `path` is
// written only where `write_path` is set; `entry` and `exit_state` may be
// null (the walk starts from `bstate`; the state above t0 is not kept).
int advntr_viterbi_backward(
    const void* lengths, const void* bstate, const void* oMI, const void* oXH,
    const void* region, const void* unit, void* path, void* stats,
    const void* entry, void* exit_state, int G, int B, int L, int P, int nb,
    int n_struct, int origin32, int mbit, int write_path, int t0,
    void* stream) {
  BwdArgs a;
  a.lengths = (const int32_t*)lengths; a.bstate = (const int32_t*)bstate;
  a.oMI = oMI; a.oXH = oXH;
  a.region = (const int32_t*)region; a.unit = (const int32_t*)unit;
  a.path = (int32_t*)path; a.stats = (int32_t*)stats;
  a.B = B; a.L = L; a.P = P; a.nb = nb; a.n_struct = n_struct;
  a.mbit = mbit;
  a.entry = (const int32_t*)entry; a.exit_state = (int32_t*)exit_state;
  a.t0 = t0;
  const int threads = 32 * WARPS_PER_CTA;
  const dim3 blocks((B + WARPS_PER_CTA - 1) / WARPS_PER_CTA, G);
  const bool staged = n_struct <= MAX_STRUCT;
  const size_t shared = staged ? (size_t)n_struct * sizeof(int32_t) : 0;
  cudaStream_t s = (cudaStream_t)stream;
#define ADVNTR_WALK(OT, WP, ST) \
  viterbi_backward_kernel<OT, WP, ST><<<blocks, threads, shared, s>>>(a)
#define ADVNTR_WALK_PATH(OT, ST) \
  do { if (write_path) ADVNTR_WALK(OT, true, ST); \
       else ADVNTR_WALK(OT, false, ST); } while (0)
  if (origin32) {
    if (staged) ADVNTR_WALK_PATH(int32_t, true);
    else ADVNTR_WALK_PATH(int32_t, false);
  } else {
    if (staged) ADVNTR_WALK_PATH(int16_t, true);
    else ADVNTR_WALK_PATH(int16_t, false);
  }
#undef ADVNTR_WALK_PATH
#undef ADVNTR_WALK
  return (int)cudaGetLastError();
}

}  // extern "C"
