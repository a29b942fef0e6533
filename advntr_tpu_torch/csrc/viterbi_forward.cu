// B1: fused structured-Viterbi forward with argmax provenance, for a group
// of G same-shape loci in one launch.
//
// Replaces the TPU kernel advntr_tpu/ops/pallas_viterbi.py::_fused_kernel
// (launched by pallas_fused_forward).  The plain PyTorch twin is
// advntr_tpu_torch/ops/viterbi_fused.py::fused_forward_reference; this
// kernel forms the same float32 sums in the same order and breaks every
// tie the same way (the first candidate wins a pick; the lowest index wins
// an argmax), so both give the same planes, bit for bit.
//
// What bounds it on an H100.  The bytes: each read writes L * (2P + 2nb)
// origin codes, 1.39 GB of int16 at B=4096, L=160, P=512, against a few
// hundred KB of model tables that stay in L1/L2; at 3.35 TB/s that is a
// floor of about 0.4 ms.  The kernel sits far above that floor.  A read's L
// columns are serial and every column is a chain of dependent phases over
// the P positions; measured by leaving one part out at a time (PERF.md),
// the time goes to the traffic through shared memory and the shuffle
// unit (every exchange between positions), to the barrier-bounded phases
// in which few warps work (the unit section), and only then to
// arithmetic: the emitting layer's adds and compares are nearly free.
//
// The design.  One CTA per (read, locus), grid (B, G); one thread per
// match position p, so each column's plane row is one coalesced store.
// The thread keeps its own M_p, I_p, D_p, its neighbour's values and all
// per-position model constants in registers, the round weights Wd[r, p]
// among them; shared memory carries only what crosses threads, each
// (value, origin) pair as one 64-bit word, and the emissions by base, so
// a column reads its (eM, eI) pair in one coalesced load.  Per active
// column there are 3 + rounds block-wide barriers, 12 at P=512 with 9
// delete-chain rounds:
//
//   - the emitting layer, then barrier 1 (new M|I and I0 visible);
//   - the delete chain D_j = max(D_{j-1} + dd_j, b_j) as the reference's
//     log-doubling rounds over the window weights Wd, each round one
//     64-bit store, a barrier and one 64-bit load.  The short rounds
//     do not run on warp shuffles: shuffles share their pipe with shared
//     memory, and the 32-position halo they need costs more than the five
//     barriers it saves.  64 registers and two CTAs an SM beat three or
//     four CTAs at 40 or 32 registers with spills (both measured,
//     PERF.md);
//   - block-end extraction, then a barrier (block ends visible);
//   - the unit-start chain, the unit ends, the prefix hub's first-max and
//     the new hubs touch C + 2 values: warp 0 runs them in registers with
//     shuffles and two warp reductions (a lane takes units lane,
//     lane + 32, ...), then a barrier (new hubs visible);
//   - the hub entry of the delete chain, D = pick(chain, hub + hub_d), is
//     formed by the consumers at the start of the next column from the
//     chain value and the new hubs, which saves the column-end barrier.
//
// A column at or past the read's length freezes the state: it only writes
// its plane row from the frozen registers, with no barrier at all (the
// length is uniform over the CTA).
//
// Shapes.  The cache pads P to a multiple of 128; any P from 32 to 1024
// runs (the last warp's lanes past P idle along on position P - 1 and
// write nothing).  The cache pads C to 8, 16, 24 or a multiple of 32, and
// nb = C + 2; a lane of warp 0 takes up to MAX_UPL units, so C <= 128.
//
// Segments.  A launch covers the columns t0 .. t0 + L - 1 of its reads.
// It may enter with the state a launch over the columns before left
// (floats M|I, D, I0, hub; origins Do, hubpo: the twin's loop state), may
// leave its own exit state behind, and may run without writing planes.
// The checkpointed traceback (ops/viterbi_ckpt.py) is built from such
// launches.  D is kept here before its hub entry and the state holds it
// after, so the exit applies the hub entry; an entry value that has it
// already passes through the consumers' own hub entry unchanged.
//
// Wide models.  A long-read model is as wide as its longest read window:
// P of several thousand, more units than a warp takes, more than
// MAX_ROUNDS doubling rounds.  They take the second entry,
// viterbi_forward_wide_kernel, which spreads each (read, locus) over a
// thread block cluster of n CTAs on neighbouring SMs: CTA r holds the
// slice of W consecutive positions from r * W (ops/_kernels.py::
// wide_layout: the fewest CTAs with W <= 1024, rounded up to a warp; past
// 16 x 1024 positions a thread takes two).  What bounds it: the bytes of
// its planes (0.10 ms a 512-column segment at B 64, P 2,560) and, a
// column, its barriers across the cluster and the edge traffic through
// distributed shared memory.  The design this one replaced, one CTA
// striding over the positions with the state in device memory (L2), was
// measured by leaving one part out at a time (PERF.md): the stream of
// tables from global memory every column cost 28% of it, its 22 block
// barriers a column 28%, the L2 round trips of the state 5%, and the rest
// was 3 turns of 1,024 threads over the positions in every phase.  This
// design does about each:
//
//   - a thread per position, its constants and round weights in registers
//     (rounds past MAX_ROUNDS in shared memory), the emissions by base and
//     the halo's tables staged once, so no per-position table is read from
//     device memory inside the column loop.  The per-unit and per-block
//     tables (unit_last, Wu, eI0 and the block rows) are staged too where
//     warp 0 runs the unit section (C <= 32 * MAX_UPL): read from L1
//     there, they cost 40% at P 2,560, C 64 (PERF.md).  Past that they are
//     read from L1, which costs nothing measurable at C 480 and frees 88
//     bytes of shared memory a unit: a unit then costs 16 (the hubs, their
//     origins, I0, an index), as the unit chain's buffers share the rounds'
//     buffers, free once the chain is done, up to C of about 2(W + H) / 3,
//     and 40 past it.  Where even those do not fit beside the slice (past
//     16 x 1,024 positions, two positions a thread, with motifs under
//     about 7.5 bp), each CTA keeps the per-unit and per-block arrays (the
//     unit chain's buffers, the gathered block ends, I0, the hubs and
//     their origins) in its own slice of a scratch buffer in device
//     memory that the wrapper allocates, read through L1, and the units
//     run over several warps; every other array stays in shared memory,
//     and a model whose arrays fit keeps the shared-memory build
//     (ops/_kernels.py::wide_layout decides, and holds the limits);
//   - the state in each CTA's shared memory; a slice's last position hands
//     its new (M, I) and its chain value to the next CTA's edge words (the
//     last CTA to the first: the roll's wrap at P);
//   - two barriers across the cluster a column: after the emitting layer
//     (new M|I, edges, I0) and after the block ends.  The delete chain's
//     first HALO_ROUNDS doubling rounds need none: each CTA also forms the
//     chain inputs of the 2^rounds - 1 positions left of its slice (the
//     halo, wrapping at P) from its neighbours' new M|I, and runs the
//     rounds over halo and slice with block barriers, the same operations
//     in the same order as the roll, so its slice comes out as the twin's.
//     A barrier across the cluster costs about 0.4 us more than a block
//     barrier (PERF.md: a barrier a round was 1.47 times slower); rounds
//     past HALO_ROUNDS (a block longer than 512 positions) take one each;
//   - the hubs need none either: every CTA gathers the C + 1 block ends
//     from their owners and runs the unit-start chain, the unit ends and
//     the prefix hub's first-max itself, with the same operations on the
//     same values, so every CTA's copy of the hubs is the same; the units
//     spread over as many warps as C needs, a round a barrier among them;
//   - every CTA also forms all nb I0 values itself; the first CTA writes
//     their plane row.
//
// It is the twin's column, phase by phase, with the first entry's order of
// operations, and gives its planes bit for bit on a model both take.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG = -1e30f;
constexpr int MAX_ROUNDS = 10;    // k < P <= 1024
constexpr int MAX_UPL = 4;        // units per lane of warp 0
constexpr unsigned FULL = 0xffffffffu;

// rows of the per-position float table: the order of POS_ROWS in
// advntr_tpu_torch/ops/struct_model.py
enum {
  R_A_MM, R_A_IM, R_A_DM, R_ENT_M, R_I0_M, R_MI, R_II, R_DI, R_MD, R_IDW,
  R_I0_D, R_HUB_D, R_XM, R_XI, R_XD, R_M_START, R_I_START, R_LE_M, R_LE_I
};
constexpr int N_POS_ROWS = R_LE_I + 1;
// rows of the per-block float table (BLK_ROWS)
enum { B_I0_I, B_HUB_I0, B_I0_START, B_LE_I0 };
constexpr int N_BLK_ROWS = B_LE_I0 + 1;

struct FwdArgs {
  const int8_t* seqs;          // (G, B, L)
  const int32_t* lengths;      // (G, B)
  const float* pos;            // (G, 19, P)
  const float* blk;            // (G, 4, nb)
  const float* eM;             // (G, P, 4)
  const float* eI;             // (G, P, 4)
  const float* eI0;            // (G, nb, 4)
  const float* Wd;             // (G, n_rounds_p, P)
  const float* Wu;             // (G, n_rounds_c, C)
  const int32_t* blk_idx;      // (G, P)
  const int32_t* exp_base;     // (G, P)
  const int32_t* unit_last;    // (G, C)
  const int32_t* suffix_last;  // (G,)
  const float* r_unit;         // (G,)
  void* oMI;                   // (G, L, B, 2P) int16 or int32
  void* oXH;                   // (G, L, B, 2nb)
  float* best;                 // (G, B)
  int32_t* bstate;             // (G, B)
  // the state the reads stand in before column t0, null before column 0:
  // floats (G, B, 3P + 2nb) = M|I, D, I0, hub; ints (G, B, P + nb) = Do,
  // hubpo
  const float* entry_f;
  const int32_t* entry_i;
  float* exit_f;               // the state after the last column, or null
  int32_t* exit_i;
  int B, L, P, nb, C, n_rounds_p, n_rounds_c, mbit;
  int cl_n, cl_w;              // wide entry: CTAs a cluster, positions a CTA
  int t0;                      // the read column of seqs[.., 0]
  int planes;                  // 0: write no origin planes
  float ln05;
  // wide entry, where the per-unit arrays do not fit in shared memory:
  // (G, B, cl_n) slices of wide_unit_words(C, nb) 64-bit words
  float2* uscr;
};

// tropical (max, origin) combine: the incumbent keeps ties
__device__ __forceinline__ void pick(float& v, int& o, float v2, int o2) {
  if (v2 > v) { v = v2; o = o2; }
}

// (value, index) combine for a first-max argmax: higher value, then the
// lower index
__device__ __forceinline__ void first_max(float& v, int& i, float v2,
                                          int i2) {
  if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}

// float bits as a signed integer of the same order
__device__ __forceinline__ int ordered_bits(float v) {
  const int i = __float_as_int(v);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ void warp_first_max(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    float v2 = __shfl_down_sync(FULL, v, off);
    int i2 = __shfl_down_sync(FULL, i, off);
    first_max(v, i, v2, i2);
  }
}

// a barrier among the first n threads of the CTA (a multiple of 32)
__device__ __forceinline__ void named_sync(int n) {
  asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
}

// The block-level section of one column, run by warp 0 alone: unit-start
// chain, unit ends, the prefix hub and the new hubs, from the block ends
// in qs into (hubs, hubpos).  Lane l holds units l, l + 32, ...
template <int UPL>
__device__ __forceinline__ void unit_section(
    const int lane, const int C, const int nb, const int n_rounds_c,
    const int suffix_last, const float r_unit, const float ln05,
    const float2* qs, const int* uls, const float* Wus, float* hubs,
    int* hubpos) {
  float us[UPL], q[UPL];
  int uso[UPL], qo[UPL];
#pragma unroll
  for (int u = 0; u < UPL; ++u) {
    const int c = lane + 32 * u;
    const int cc = c < C ? c : C - 1;      // lanes past C compute unused values
    const float2 qe = qs[uls[cc]];
    q[u] = qe.x; qo[u] = __float_as_int(qe.y);
    if (c == 0) {
      const bool has = suffix_last >= 0;
      const float2 qsuf = qs[has ? suffix_last : 0];
      us[u] = has ? qsuf.x : 0.f;
      uso[u] = has ? __float_as_int(qsuf.y) : 0;
    } else {
      const float2 qp = qs[uls[cc > 0 ? cc - 1 : 0]];
      us[u] = qp.x + ln05; uso[u] = __float_as_int(qp.y);
    }
  }
  for (int r = 0; r < n_rounds_c; ++r) {
    const int k = 1 << r;
    if (k >= C) break;
    float nv[UPL];
    int no[UPL];
#pragma unroll
    for (int u = 0; u < UPL; ++u) {
      const int c = lane + 32 * u;
      const int cc = c < C ? c : C - 1;
      const int cs = cc >= k ? cc - k : cc - k + C;   // the roll's wraparound
      const int sl = cs & 31, su = cs >> 5;
      float sv = 0.f;
      int so = 0;
#pragma unroll
      for (int uu = 0; uu < UPL; ++uu) {
        const float tv = __shfl_sync(FULL, us[uu], sl);
        const int to = __shfl_sync(FULL, uso[uu], sl);
        if (uu == su) { sv = tv; so = to; }
      }
      nv[u] = us[u]; no[u] = uso[u];
      pick(nv[u], no[u], sv + Wus[r * C + cc], so);
    }
#pragma unroll
    for (int u = 0; u < UPL; ++u) { us[u] = nv[u]; uso[u] = no[u]; }
  }
  // unit ends, and their first-max: the prefix hub
  float pv = -INFINITY;
  int pi = 0x7fffffff;
#pragma unroll
  for (int u = 0; u < UPL; ++u) {
    pick(q[u], qo[u], us[u] + r_unit, uso[u]);
    const int c = lane + 32 * u;
    if (c < C) first_max(pv, pi, q[u] + ln05, c);
  }
  // first-max over the warp by two reductions: the highest value (as an
  // order-preserving integer, -0 counted as +0 like the float compare
  // does), then the lowest unit that holds it
  const int key = ordered_bits(pv + 0.f);
  const int top = __reduce_max_sync(FULL, key);
  pi = __reduce_min_sync(FULL, key == top ? pi : 0x7fffffff);
  pv = __shfl_sync(FULL, pv, pi & 31);
  int po = 0;
#pragma unroll
  for (int uu = 0; uu < UPL; ++uu) {
    const int to = __shfl_sync(FULL, qo[uu], pi & 31);
    if (uu == (pi >> 5)) po = to;
  }
  // new hubs: none for the suffix block, the unit starts, the prefix hub
  if (lane == 0) { hubs[0] = NEG; hubpos[0] = -1; }
#pragma unroll
  for (int u = 0; u < UPL; ++u) {
    const int c = lane + 32 * u;
    if (c < C) { hubs[c + 1] = us[u]; hubpos[c + 1] = uso[u]; }
  }
  for (int bq = C + 1 + lane; bq < nb; bq += 32) {
    hubs[bq] = pv; hubpos[bq] = po;
  }
}

// CARRY: the launch is a segment (an entry or exit state, a first column
// past 0, or no planes).  Whole reads compile without any of it.
template <typename OT, int UPL, bool CARRY>
__global__ void __launch_bounds__(1024, 1)
viterbi_forward_kernel(const FwdArgs a) {
  const int P = a.P, nb = a.nb, C = a.C, L = a.L;
  const int b = blockIdx.x, g = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const bool is_pos = tid < P;
  const bool is_blk = tid < nb;
  const int p = is_pos ? tid : P - 1;    // the position whose tables are read

  // this locus's tables
  const float* pos = a.pos + (size_t)g * N_POS_ROWS * P;
  const float* blkt = a.blk + (size_t)g * N_BLK_ROWS * nb;
  const float* eM = a.eM + (size_t)g * P * 4;
  const float* eI = a.eI + (size_t)g * P * 4;
  const float* eI0 = a.eI0 + (size_t)g * nb * 4;
  const float* Wd = a.Wd + (size_t)g * a.n_rounds_p * P;
  const float* Wu = a.Wu + (size_t)g * a.n_rounds_c * C;
  const int32_t* blk_idx = a.blk_idx + (size_t)g * P;
  const int suffix_last = a.suffix_last[g];
  const float r_unit = a.r_unit[g];
  const size_t read = (size_t)g * a.B + b;

  extern __shared__ float smem[];
  // P 64-bit words each: (M_p, I_p) of this column; two round buffers,
  // the chain before its hub entry and the block-end extraction, each as
  // (value, origin bits)
  float2* MIs = (float2*)smem;
  float2* Dr0 = MIs + P;
  float2* Dr1 = Dr0 + P;
  float2* Dps = Dr1 + P;
  float2* qs = Dps + P;
  float2* ems = qs + P;                  // 4 x P: (eM, eI)[base][p]
  float* I0ns = (float*)(ems + 4 * P);   // nb each below
  float* hubs = I0ns + nb;
  int* hubpos = (int*)(hubs + nb);
  int* uls = hubpos + nb;                // C: unit_last
  float* Wus = (float*)(uls + C);        // n_rounds_c * C
  float* redv = Wus + a.n_rounds_c * C;  // 32
  int* redi = (int*)(redv + 32);         // 32
  int8_t* seq_s = (int8_t*)(redi + 32);  // L: the read, clipped to 0..3

  // per-position constants in registers: own position, and the position
  // below (tp) for its D
  const float* rw = pos + p;
  const float a_mm = rw[R_A_MM * P], a_im = rw[R_A_IM * P],
              a_dm = rw[R_A_DM * P], ent_m = rw[R_ENT_M * P],
              i0_m = rw[R_I0_M * P], mi = rw[R_MI * P], ii = rw[R_II * P],
              di = rw[R_DI * P], md = rw[R_MD * P], idw = rw[R_IDW * P],
              i0_d = rw[R_I0_D * P], hub_d = rw[R_HUB_D * P],
              xm = rw[R_XM * P], xi = rw[R_XI * P], xd = rw[R_XD * P];
  const int blk = blk_idx[p];
  const int expb = a.exp_base[(size_t)g * P + p];
  const int blkcode = 2 * P + blk;        // I0 origin code of p's block
  const int hubsent = blkcode + nb;       // hub sentinel of p's block
  // shifted sources wrap like the reference's lane roll; the weights at
  // block starts are NEG, so a wrapped value can only reach a state no
  // finite path uses, exactly as in the reference
  const int tp = p == 0 ? P - 1 : p - 1;
  const float hub_d_p = pos[R_HUB_D * P + tp];
  const int blk_p = blk_idx[tp];
  float wd[MAX_ROUNDS];         // this position's round weights
#pragma unroll
  for (int r = 0; r < MAX_ROUNDS; ++r)
    wd[r] = r < a.n_rounds_p ? Wd[r * P + p] : NEG;
  // the entry state of this read, or the state before column 0
  const int SF = 3 * P + 2 * nb, SI = P + nb;
  const float* ef = CARRY && a.entry_f ? a.entry_f + read * SF : nullptr;
  const int32_t* ei = CARRY && a.entry_i ? a.entry_i + read * SI : nullptr;
  const bool planes = !CARRY || a.planes != 0;
  const int t0 = CARRY ? a.t0 : 0;
  if (is_blk) {
    hubs[tid] = ef ? ef[3 * P + nb + tid] : NEG;
    hubpos[tid] = ei ? ei[P + tid] : 0;
    I0ns[tid] = ef ? ef[3 * P + tid] : NEG;
  }
  if (is_pos) {
    // emissions by base first, so a column's read is one coalesced load
#pragma unroll
    for (int c = 0; c < 4; ++c)
      ems[c * P + tid] = make_float2(eM[tid * 4 + c], eI[tid * 4 + c]);
  }
  if (is_pos)
    Dps[tid] = ef ? make_float2(ef[2 * P + tid], __int_as_float(ei[tid]))
                  : make_float2(NEG, __int_as_float(0));
  if (tid < C) uls[tid] = a.unit_last[(size_t)g * C + tid];
  for (int i = tid; i < a.n_rounds_c * C; i += blockDim.x) Wus[i] = Wu[i];
  for (int i = tid; i < L; i += blockDim.x) {
    const int base = a.seqs[read * L + i];
    seq_s[i] = (int8_t)(base < 0 ? 0 : (base > 3 ? 3 : base));
  }
  const int len = a.lengths[read];
  // this thread's entries of the read's plane rows, one column apart
  const size_t colMI = (size_t)a.B * 2 * P;
  OT* pMI = planes
      ? (OT*)a.oMI + ((size_t)g * L * a.B + b) * 2 * P + p : nullptr;

  // the DP state a thread carries from column to column
  float vM = ef ? ef[p] : NEG;            // M_p, I_p
  float vI = ef ? ef[P + p] : NEG;
  // the rolled sources of M_p (M_{p-1}, I_{p-1}; position 0 takes the
  // roll's wrap)
  float mnb = ef ? (p == 0 ? ef[2 * P - 1] : ef[p - 1]) : NEG;
  float inb = ef ? (p == 0 ? ef[P - 1] : ef[P + p - 1]) : NEG;
  float Din = ef ? ef[2 * P + p] : NEG;   // D_p before its hub entry
  int Dino = ei ? ei[p] : 0;              // and its origin
  float i0_blk = ef ? ef[3 * P + blk] : NEG;    // I0 of p's block
  __syncthreads();

  for (int t = 0; t < L; ++t) {
    const int base = seq_s[t];
    const int tg = t0 + t;                // the read's column
    const bool act = tg < len;

    // ---- emitting layer: sources from the previous column ----
    {
      const float2 em = ems[base * P + p];
      const float eMv = em.x, eIv = em.y;
      float nM, nI;
      int oM, oI;
      if (tg == 0) {
        nM = rw[R_M_START * P] + eMv; nI = rw[R_I_START * P] + eIv;
        oM = -1; oI = -1;
      } else {
        const float hb = hubs[blk];
        float v5 = hb + ent_m;
        int o5 = hubsent;
        pick(v5, o5, i0_blk + i0_m, blkcode);
        // D of the previous column: the chain value, then its hub entry
        const float2 dprev = Dps[tp];
        float dp = dprev.x;
        int dpo = __float_as_int(dprev.y);
        pick(dp, dpo, hubs[blk_p] + hub_d_p, 2 * P + nb + blk_p);
        float dc = Din;
        int dco = Dino;
        pick(dc, dco, hb + hub_d, hubsent);
        float v = mnb + a_mm;
        int o = tid - 1;
        pick(v, o, inb + a_im, P + tid - 1);
        pick(v, o, dp + a_dm, dpo);
        pick(v, o, v5, o5);
        nM = eMv + v; oM = o;
        float w = vM + mi;
        int ow = tid;
        pick(w, ow, vI + ii, P + tid);
        pick(w, ow, dc + di, dco);
        pick(w, ow, NEG, o5);
        nI = eIv + w; oI = ow;
      }
      if (planes) {
        if (is_pos) {
          pMI[0] = (OT)(oM + 1 + (base == expb ? a.mbit : 0));
          pMI[P] = (OT)(oI + 1);
        }
        pMI += colMI;
      }
      if (act) {
        vM = nM; vI = nI;
        if (is_pos) MIs[tid] = make_float2(nM, nI);
      }
    }
    if (is_blk) {
      // block tid's I0 lives in I0ns[tid]: only this thread reads it here,
      // the others read it after the barrier
      const float e0 = eI0[tid * 4 + base];
      float v0;
      int o0;
      if (tg == 0) {
        v0 = blkt[B_I0_START * nb + tid] + e0; o0 = -1;
      } else {
        v0 = I0ns[tid] + blkt[B_I0_I * nb + tid]; o0 = 2 * P + tid;
        pick(v0, o0, hubs[tid] + blkt[B_HUB_I0 * nb + tid],
             2 * P + nb + tid);
        v0 = e0 + v0;
      }
      if (planes) {
        OT* pXH =
            (OT*)a.oXH + (((size_t)g * L + t) * a.B + b) * 2 * nb + tid;
        pXH[0] = (OT)(o0 + 1);
        pXH[nb] = (OT)(hubpos[tid] + 1);
      }
      if (act) I0ns[tid] = v0;
    }
    if (!act) {             // length freeze: the state stays as it is
      if (!planes) break;   // and nothing is left to write
      continue;
    }
    __syncthreads();        // new M|I and I0 visible

    // ---- delete chain: D_j = max(D_{j-1} + dd_j, b_j), by doubling ----
    {
      // the roll of the concatenated M|I row: position 0 takes I_{P-1}
      // where the others take M_{p-1}, and M_{P-1} where they take I_{p-1}
      const float2 below = MIs[tp];
      mnb = p == 0 ? below.y : below.x;
      inb = p == 0 ? below.x : below.y;
    }
    i0_blk = I0ns[blk];
    Din = mnb + md; Dino = tid - 1;
    pick(Din, Dino, inb + idw, P + tid - 1);
    pick(Din, Dino, i0_blk + i0_d, blkcode);
#pragma unroll
    for (int r = 0; r < MAX_ROUNDS; ++r) {
      const int k = 1 << r;
      if (r < a.n_rounds_p && k < P) {
        float2* dr = (r & 1) ? Dr1 : Dr0;
        if (is_pos) dr[tid] = make_float2(Din, __int_as_float(Dino));
        __syncthreads();
        const float2 src = dr[p >= k ? p - k : p - k + P];
        const float rv = src.x + wd[r];
        if (rv > Din) { Din = rv; Dino = __float_as_int(src.y); }
      }
    }

    // ---- block-end extraction ----
    {
      float qv = vM + xm;
      int qo = tid;
      pick(qv, qo, vI + xi, P + tid);
      pick(qv, qo, Din + xd, Dino);
      if (is_pos) {
        qs[tid] = make_float2(qv, __int_as_float(qo));
        Dps[tid] = make_float2(Din, __int_as_float(Dino));
      }
    }
    __syncthreads();        // block ends visible

    // ---- unit-start chain, unit ends, prefix hub, new hubs: warp 0 ----
    if (tid < 32)
      unit_section<UPL>(lane, C, nb, a.n_rounds_c, suffix_last, r_unit,
                        a.ln05, qs, uls, Wus, hubs, hubpos);
    __syncthreads();        // new hubs visible
  }

  // ---- best end score and end state (first max over 2P + nb) ----
  float v = -INFINITY;
  int i = 0x7fffffff;
  if (is_pos) {
    first_max(v, i, vM + rw[R_LE_M * P], tid);
    first_max(v, i, vI + rw[R_LE_I * P], P + tid);
  }
  if (is_blk)
    first_max(v, i, I0ns[tid] + blkt[B_LE_I0 * nb + tid], 2 * P + tid);
  warp_first_max(v, i);
  const int warp = tid >> 5;
  if (lane == 0) { redv[warp] = v; redi[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    v = lane < n_warps ? redv[lane] : -INFINITY;
    i = lane < n_warps ? redi[lane] : 0x7fffffff;
    warp_first_max(v, i);
    if (lane == 0) { a.best[read] = v; a.bstate[read] = i; }
  }

  // ---- the exit state: D takes its hub entry here ----
  if (CARRY && a.exit_f) {
    float* xf = a.exit_f + read * SF;
    int32_t* xi = a.exit_i + read * SI;
    if (is_pos) {
      float dc = Din;
      int dco = Dino;
      pick(dc, dco, hubs[blk] + hub_d, hubsent);
      xf[tid] = vM; xf[P + tid] = vI;
      xf[2 * P + tid] = dc; xi[tid] = dco;
    }
    if (is_blk) {
      xf[3 * P + tid] = I0ns[tid];
      xf[3 * P + nb + tid] = hubs[tid];
      xi[P + tid] = hubpos[tid];
    }
  }
}

// ---- the wide entry: one thread block cluster per (read, locus) ----------

constexpr int WIDE_MAX_CLUSTER = 16;   // CTAs a cluster (8 portable)
constexpr int WIDE_MAX_PPT = 2;        // positions a thread
constexpr int WIDE_MAX_ROUNDS = 15;    // k < P <= 16 * 1024 * 2
constexpr int WIDE_MAX_WARPS = 32;
constexpr int HALO_ROUNDS = 9;         // rounds run on the halo, locally
constexpr size_t WIDE_SMEM_MAX = 232448;   // shared bytes a CTA can have

// delete-chain rounds that run (k = 2^r < P), and those past the
// MAX_ROUNDS a thread holds in registers, whose weights stay in shared
// memory
__host__ __device__ inline int wide_rounds(int P, int n_rounds_p) {
  int r = 0;
  while (r < n_rounds_p && (1 << r) < P) ++r;
  return r;
}

// Bytes of shared memory a CTA of the wide entry carves, for a slice of W
// positions and a halo of H: 64-bit (value, origin) words first (M|I, the
// rounds' two buffers of H + W, which the unit chain's two buffers and the
// C + 1 block ends it reads share once the rounds are done, the chain
// before its hub entry, the block ends, the emissions by base, the two
// slice edges), then 32-bit words (the round weights past MAX_ROUNDS, the
// halo's round weights and tables, I0, the hubs and their origins, the
// units' own indices, for C <= 32 * MAX_UPL the staged tables: unit_last,
// Wu, three block rows and eI0 by base; the warp and cluster reductions).
// With `units_off` the per-unit and per-block arrays are in device memory
// (wide_unit_words) and none of them is carved.  ops/_kernels.py::
// wide_layout computes the same number; the entry point refuses a launch
// where the two differ.
__host__ __device__ inline size_t wide_smem_bytes(int W, int P, int nb,
                                                  int C, int n_rounds_p,
                                                  int n_rounds_c,
                                                  bool units_off) {
  const int r = wide_rounds(P, n_rounds_p);
  const size_t xr = r > MAX_ROUNDS ? r - MAX_ROUNDS : 0;
  const size_t rh = r < HALO_ROUNDS ? r : HALO_ROUNDS;
  const size_t H = ((size_t)1 << rh) - 1;
  const size_t rounds_buf = 2 * (H + (size_t)W);
  const size_t unit_buf = units_off ? 0 : 3 * (size_t)C + 1;
  const size_t units = units_off ? 0 : 3 * (size_t)nb + (size_t)C;
  const size_t staged = !units_off && C <= 32 * MAX_UPL
                            ? (size_t)(1 + n_rounds_c) * C + 7 * (size_t)nb
                            : 0;
  return 8 * (7 * (size_t)W + 2 +
              (rounds_buf > unit_buf ? rounds_buf : unit_buf)) +
         4 * (xr * W + (rh + 4) * H + units + staged +
              3 * WIDE_MAX_WARPS + 2 * WIDE_MAX_CLUSTER);
}

// 64-bit words of device memory a CTA keeps the per-unit and per-block
// arrays in where they do not fit in shared memory: the unit chain's two
// buffers (2C), the block ends (C + 1), then I0, the hubs and their
// origins (nb 32-bit words each)
__host__ __device__ inline size_t wide_unit_words(int C, int nb) {
  return 3 * (size_t)C + 1 + (3 * (size_t)nb + 1) / 2;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// a word of the same shared array in CTA `rank` of the cluster
template <typename T>
__device__ __forceinline__ T* dsmem(T* local, unsigned rank) {
  return cg::this_cluster().map_shared_rank(local, rank);
}

// the (value, origin) word of position x, whichever CTA holds it; `xs` is
// this CTA's array of W words, indexed by position - rank * W
__device__ __forceinline__ float2 word_at(float2* xs, int x, int s, int W,
                                          unsigned rank) {
  if (x >= s && x < s + W) return xs[x - s];
  const unsigned r = (unsigned)(x / W);
  return *dsmem(xs + (x - (int)r * W), r);
}

// per-position constants and state a thread keeps in registers
struct WidePos {
  int p, l;                   // position, and its slot in this CTA
  bool valid;                 // false: a lane past P, idling along
  float a_mm, a_im, a_dm, ent_m, i0_m, mi, ii, di, md, idw, i0_d, hub_d,
      xm, xi, xd, hub_d_p;
  int blk, blk_p, expb;
  float wd[MAX_ROUNDS];
  float vM, vI, mnb, inb, Din, i0_blk;
  int Dino;
};

// UPL: units a lane of warp 0 takes (C <= 32 * UPL), as in the first
// entry; 0 spreads the units over as many warps as C needs.  UNITS_OFF:
// the per-unit and per-block arrays are in this CTA's slice of a.uscr
// (with UPL 0)
template <typename OT, int PPT, int UPL, bool UNITS_OFF>
__global__ void __launch_bounds__(1024, 1)
viterbi_forward_wide_kernel(const FwdArgs a) {
  const int P = a.P, nb = a.nb, C = a.C, L = a.L;
  const int n = a.cl_n, W = a.cl_w, T = blockDim.x;
  const unsigned rank = cluster_rank();
  const int b = blockIdx.x / n, g = blockIdx.y;
  const int tid = threadIdx.x;
  const int s = (int)rank * W;                    // this CTA's slice
  const int e = s + W < P ? s + W : P;
  const unsigned right = rank + 1 == (unsigned)n ? 0 : rank + 1;
  const int rounds = wide_rounds(P, a.n_rounds_p);
  const int rh = rounds < HALO_ROUNDS ? rounds : HALO_ROUNDS;
  const int H = (1 << rh) - 1;           // halo: positions left of the slice
  const int WH = W + H;

  const float* pos = a.pos + (size_t)g * N_POS_ROWS * P;
  const float* blkt = a.blk + (size_t)g * N_BLK_ROWS * nb;
  const float* eM = a.eM + (size_t)g * P * 4;
  const float* eI = a.eI + (size_t)g * P * 4;
  const float* eI0 = a.eI0 + (size_t)g * nb * 4;
  const float* Wd = a.Wd + (size_t)g * a.n_rounds_p * P;
  const float* Wu = a.Wu + (size_t)g * a.n_rounds_c * C;
  const int32_t* blk_idx = a.blk_idx + (size_t)g * P;
  const int suffix_last = a.suffix_last[g];
  const float r_unit = a.r_unit[g];
  const float ln05 = a.ln05;
  const size_t read = (size_t)g * a.B + b;
  const int8_t* seq = a.seqs + read * L;

  extern __shared__ float2 wsm[];
  float2* MIs = wsm;                     // W each: new (M_p, I_p)
  float2* Dps = MIs + W;                 // the chain before its hub entry
  float2* qs = Dps + W;                  // block ends
  float2* ems = qs + W;                  // 4W: (eM, eI)[base][slot]
  float2* edge = ems + 4 * W;            // 2: the left neighbour's last
                                         // new (M, I) and chain value
  float2* Dr = edge + 2;                 // 2(H + W): the rounds' buffers,
                                         // halo then slice; once the rounds
                                         // are done, the unit arrays below
  // the per-unit and per-block arrays: after the rounds' buffers in shared
  // memory, or this CTA's own slice of the scratch buffer
  float2* const uarr =
      UNITS_OFF ? a.uscr + (read * n + rank) * wide_unit_words(C, nb) : Dr;
  float2* ub = uarr;                     // 2C: the unit chain's buffers
  float2* qe = ub + 2 * C;               // C + 1: the block ends of the
                                         // units and the suffix
  const int n_dr =
      UNITS_OFF || 2 * WH > 3 * C + 1 ? 2 * WH : 3 * C + 1;
  float* wdx = (float*)(Dr + n_dr);      // rounds past MAX_ROUNDS x W
  const int xr = rounds > MAX_ROUNDS ? rounds - MAX_ROUNDS : 0;
  float* wh = wdx + xr * W;              // rh x H: the halo's weights
  float* hmd = wh + rh * H;              // H each: the halo's tables
  float* hidw = hmd + H;
  float* hi0d = hidw + H;
  int* hblk = (int*)(hi0d + H);
  float* I0ns = UNITS_OFF ? (float*)(qe + C + 1)   // nb each: I0, the hubs
                          : (float*)(hblk + H);    // and their origins
  float* hubs = I0ns + nb;
  int* hubpos = (int*)(hubs + nb);
  int* idu = hubpos + nb;                // C: unit c's index in qe, c
  // warp 0's unit section (UPL > 0) reads its tables from shared memory,
  // more units read them from L1 (the header says why)
  constexpr bool staged = UPL > 0;
  int* uls_s = idu + C;                  // C: unit_last
  float* Wu_s = (float*)(uls_s + C);     // n_rounds_c x C
  float* blk_s = Wu_s + a.n_rounds_c * C;   // 3 x nb: three block rows
  float* eI0_s = blk_s + 3 * nb;         // 4 x nb: eI0[base][block]
  float* redv = staged      ? eI0_s + 4 * nb          // WIDE_MAX_WARPS
                : UNITS_OFF ? (float*)(hblk + H)
                            : (float*)uls_s;
  const int* uls = staged ? uls_s : a.unit_last + (size_t)g * C;
  const float* Wut = staged ? Wu_s : Wu;
  const float* i0i = staged ? blk_s : blkt + B_I0_I * nb;
  const float* hubi0 = staged ? blk_s + nb : blkt + B_HUB_I0 * nb;
  const float* i0start = staged ? blk_s + 2 * nb : blkt + B_I0_START * nb;
  int* redi = (int*)(redv + WIDE_MAX_WARPS);
  int* redo = redi + WIDE_MAX_WARPS;
  float* cv = (float*)(redo + WIDE_MAX_WARPS);   // WIDE_MAX_CLUSTER each
  int* ci = (int*)(cv + WIDE_MAX_CLUSTER);

  const int SF = 3 * P + 2 * nb, SI = P + nb;
  const float* ef = a.entry_f ? a.entry_f + read * SF : nullptr;
  const int32_t* ei = a.entry_i ? a.entry_i + read * SI : nullptr;
  const bool planes = a.planes != 0;

  WidePos ps[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    WidePos& q = ps[i];
    q.l = i * T + tid;
    q.valid = s + q.l < e;
    q.p = q.valid ? s + q.l : P - 1;
    const float* rw = pos + q.p;
    q.a_mm = rw[R_A_MM * P]; q.a_im = rw[R_A_IM * P];
    q.a_dm = rw[R_A_DM * P]; q.ent_m = rw[R_ENT_M * P];
    q.i0_m = rw[R_I0_M * P]; q.mi = rw[R_MI * P]; q.ii = rw[R_II * P];
    q.di = rw[R_DI * P]; q.md = rw[R_MD * P]; q.idw = rw[R_IDW * P];
    q.i0_d = rw[R_I0_D * P]; q.hub_d = rw[R_HUB_D * P];
    q.xm = rw[R_XM * P]; q.xi = rw[R_XI * P]; q.xd = rw[R_XD * P];
    q.blk = blk_idx[q.p];
    q.expb = a.exp_base[(size_t)g * P + q.p];
    const int tp = q.p == 0 ? P - 1 : q.p - 1;
    q.hub_d_p = pos[R_HUB_D * P + tp];
    q.blk_p = blk_idx[tp];
#pragma unroll
    for (int r = 0; r < MAX_ROUNDS; ++r)
      q.wd[r] = r < rounds ? Wd[r * P + q.p] : NEG;
    for (int r = MAX_ROUNDS; r < rounds; ++r)
      wdx[(r - MAX_ROUNDS) * W + q.l] = Wd[r * P + q.p];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      ems[c * W + q.l] = make_float2(eM[q.p * 4 + c], eI[q.p * 4 + c]);
    Dps[q.l] = ef ? make_float2(ef[2 * P + q.p], __int_as_float(ei[q.p]))
                  : make_float2(NEG, __int_as_float(0));
    q.vM = ef ? ef[q.p] : NEG;
    q.vI = ef ? ef[P + q.p] : NEG;
    q.mnb = ef ? (q.p == 0 ? ef[2 * P - 1] : ef[q.p - 1]) : NEG;
    q.inb = ef ? (q.p == 0 ? ef[P - 1] : ef[P + q.p - 1]) : NEG;
    q.Din = ef ? ef[2 * P + q.p] : NEG;
    q.Dino = ei ? ei[q.p] : 0;
    q.i0_blk = ef ? ef[3 * P + q.blk] : NEG;
  }
  if (tid == 0) {
    // the chain value of the position left of the slice (P - 1 for the
    // first), as the previous column left it
    const int tp = s == 0 ? P - 1 : s - 1;
    edge[1] = ef ? make_float2(ef[2 * P + tp], __int_as_float(ei[tp]))
                 : make_float2(NEG, __int_as_float(0));
  }
  for (int q = tid; q < nb; q += T) {
    I0ns[q] = ef ? ef[3 * P + q] : NEG;
    hubs[q] = ef ? ef[3 * P + nb + q] : NEG;
    hubpos[q] = ei ? ei[P + q] : 0;
  }
  for (int j = tid; j < H; j += T) {
    const int x = ((s - H + j) % P + P) % P;
    hmd[j] = pos[R_MD * P + x];
    hidw[j] = pos[R_IDW * P + x];
    hi0d[j] = pos[R_I0_D * P + x];
    hblk[j] = blk_idx[x];
    for (int r = 0; r < rh; ++r) wh[r * H + j] = Wd[r * P + x];
  }
  if (!UNITS_OFF)
    for (int c = tid; c < C; c += T) idu[c] = c;
  if (staged) {
    for (int q = tid; q < nb; q += T) {
      blk_s[q] = blkt[B_I0_I * nb + q];
      blk_s[nb + q] = blkt[B_HUB_I0 * nb + q];
      blk_s[2 * nb + q] = blkt[B_I0_START * nb + q];
#pragma unroll
      for (int c = 0; c < 4; ++c) eI0_s[c * nb + q] = eI0[q * 4 + c];
    }
    for (int c = tid; c < C; c += T)
      uls_s[c] = a.unit_last[(size_t)g * C + c];
    for (int i = tid; i < a.n_rounds_c * C; i += T) Wu_s[i] = Wu[i];
  }
  const int len = a.lengths[read];
  // the unit section's threads: a lane a unit, as many warps as C needs
  const int n_ut = min(T, 32 * ((C + 31) / 32));
  const int n_uw = n_ut / 32;
  const size_t colMI = (size_t)a.B * 2 * P;
  OT* pMI = planes ? (OT*)a.oMI + ((size_t)g * L * a.B + b) * 2 * P
                   : nullptr;
  int next = seq[0];
  // every CTA of the cluster has started and staged its tables before
  // any reaches into another's shared memory
  cluster_sync();

  for (int t = 0; t < L; ++t) {
    const int base = next < 0 ? 0 : (next > 3 ? 3 : next);
    if (t + 1 < L) next = seq[t + 1];
    const int tg = a.t0 + t;              // the read's column
    const bool act = tg < len;

    // ---- emitting layer: sources from the previous column ----
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      WidePos& q = ps[i];
      const int p = q.p;
      const int blkcode = 2 * P + q.blk, hubsent = blkcode + nb;
      const float2 em = ems[base * W + q.l];
      float nM, nI;
      int oM, oI;
      if (tg == 0) {
        nM = pos[R_M_START * P + p] + em.x;
        nI = pos[R_I_START * P + p] + em.y;
        oM = -1; oI = -1;
      } else {
        const float hb = hubs[q.blk];
        float v5 = hb + q.ent_m;
        int o5 = hubsent;
        pick(v5, o5, q.i0_blk + q.i0_m, blkcode);
        // D of the previous column at p - 1: the chain value, then its
        // hub entry
        const float2 dprev = q.l > 0 ? Dps[q.l - 1] : edge[1];
        float dp = dprev.x;
        int dpo = __float_as_int(dprev.y);
        pick(dp, dpo, hubs[q.blk_p] + q.hub_d_p, 2 * P + nb + q.blk_p);
        float dc = q.Din;
        int dco = q.Dino;
        pick(dc, dco, hb + q.hub_d, hubsent);
        float v = q.mnb + q.a_mm;
        int o = p - 1;
        pick(v, o, q.inb + q.a_im, P + p - 1);
        pick(v, o, dp + q.a_dm, dpo);
        pick(v, o, v5, o5);
        nM = em.x + v; oM = o;
        float w = q.vM + q.mi;
        int ow = p;
        pick(w, ow, q.vI + q.ii, P + p);
        pick(w, ow, dc + q.di, dco);
        pick(w, ow, NEG, o5);
        nI = em.y + w; oI = ow;
      }
      if (planes && q.valid) {
        pMI[p] = (OT)(oM + 1 + (base == q.expb ? a.mbit : 0));
        pMI[P + p] = (OT)(oI + 1);
      }
      if (act) {
        q.vM = nM; q.vI = nI;
        MIs[q.l] = make_float2(nM, nI);
        // the slice's last position hands its values to the right
        if (q.valid && p == e - 1) *dsmem(edge, right) = make_float2(nM, nI);
      }
    }
    if (planes) pMI += colMI;
    // every CTA holds all nb I0 values and forms them alike; the first
    // writes their plane row
    for (int q = tid; q < nb; q += T) {
      const float e0 = staged ? eI0_s[base * nb + q] : eI0[q * 4 + base];
      float v0;
      int o0;
      if (tg == 0) {
        v0 = i0start[q] + e0; o0 = -1;
      } else {
        v0 = I0ns[q] + i0i[q]; o0 = 2 * P + q;
        pick(v0, o0, hubs[q] + hubi0[q], 2 * P + nb + q);
        v0 = e0 + v0;
      }
      if (planes && rank == 0) {
        OT* pXH = (OT*)a.oXH + (((size_t)g * L + t) * a.B + b) * 2 * nb + q;
        pXH[0] = (OT)(o0 + 1);
        pXH[nb] = (OT)(hubpos[q] + 1);
      }
      if (act) I0ns[q] = v0;
    }
    if (!act) {             // length freeze: the state stays as it is
      if (!planes) break;   // and nothing is left to write
      continue;
    }
    cluster_sync();         // new M|I, the slice edges and I0 visible

    // ---- delete chain: D_j = max(D_{j-1} + dd_j, b_j), by doubling ----
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      WidePos& q = ps[i];
      // the roll of the concatenated M|I row: position 0 takes I_{P-1}
      // where the others take M_{p-1}, and M_{P-1} where they take I_{p-1}
      const float2 below = q.l > 0 ? MIs[q.l - 1] : edge[0];
      q.mnb = q.p == 0 ? below.y : below.x;
      q.inb = q.p == 0 ? below.x : below.y;
      q.i0_blk = I0ns[q.blk];
      q.Din = q.mnb + q.md; q.Dino = q.p - 1;
      pick(q.Din, q.Dino, q.inb + q.idw, P + q.p - 1);
      pick(q.Din, q.Dino, q.i0_blk + q.i0_d, 2 * P + q.blk);
    }
    // the halo's chain inputs, from its left neighbours' new M|I
    for (int j = tid; j < H; j += T) {
      const int x = ((s - H + j) % P + P) % P;
      const float2 below = word_at(MIs, x == 0 ? P - 1 : x - 1, s, W, rank);
      const float mnb = x == 0 ? below.y : below.x;
      const float inb = x == 0 ? below.x : below.y;
      const int hb = hblk[j];
      float d = mnb + hmd[j];
      int o = x - 1;
      pick(d, o, inb + hidw[j], P + x - 1);
      pick(d, o, I0ns[hb] + hi0d[j], 2 * P + hb);
      Dr[j] = make_float2(d, __int_as_float(o));
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i)
      Dr[H + ps[i].l] = make_float2(ps[i].Din, __int_as_float(ps[i].Dino));
    // the first rounds on the halo and the slice, block barriers only: a
    // slot's shift stays inside the buffer for every slot a later round
    // reads
#pragma unroll
    for (int r = 0; r < HALO_ROUNDS; ++r) {
      if (r < rh) {
        const int k = 1 << r;
        const float2* from = Dr + (r & 1) * WH;
        float2* to = Dr + ((r & 1) ^ 1) * WH;
        __syncthreads();
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          WidePos& q = ps[i];
          const float2 sv = from[H + q.l - k];
          const float rv = sv.x + q.wd[r];
          if (rv > q.Din) { q.Din = rv; q.Dino = __float_as_int(sv.y); }
          to[H + q.l] = make_float2(q.Din, __int_as_float(q.Dino));
        }
        for (int j = tid; j < H; j += T) {
          float2 own = from[j];
          if (j >= k) {
            const float2 sv = from[j - k];
            const float rv = sv.x + wh[r * H + j];
            if (rv > own.x) own = make_float2(rv, sv.y);
          }
          to[j] = own;
        }
      }
    }
    // the rounds past the halo's, over the whole cluster
#pragma unroll
    for (int r = HALO_ROUNDS; r < WIDE_MAX_ROUNDS; ++r) {
      if (r < rounds) {
        const int k = 1 << r;
        float2* dr = Dr + (r & 1) * WH + H;
#pragma unroll
        for (int i = 0; i < PPT; ++i)
          dr[ps[i].l] = make_float2(ps[i].Din, __int_as_float(ps[i].Dino));
        cluster_sync();
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          WidePos& q = ps[i];
          const int src = q.p >= k ? q.p - k : q.p - k + P;
          const float2 sv = word_at(dr, src, s, W, rank);
          const float w = r < MAX_ROUNDS ? q.wd[r < MAX_ROUNDS ? r : 0]
                                         : wdx[(r - MAX_ROUNDS) * W + q.l];
          const float rv = sv.x + w;
          if (rv > q.Din) { q.Din = rv; q.Dino = __float_as_int(sv.y); }
        }
      }
    }

    // ---- block-end extraction ----
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      WidePos& q = ps[i];
      float qv = q.vM + q.xm;
      int qo = q.p;
      pick(qv, qo, q.vI + q.xi, P + q.p);
      pick(qv, qo, q.Din + q.xd, q.Dino);
      qs[q.l] = make_float2(qv, __int_as_float(qo));
      const float2 d = make_float2(q.Din, __int_as_float(q.Dino));
      Dps[q.l] = d;
      if (q.valid && q.p == e - 1) dsmem(edge, right)[1] = d;
    }
    cluster_sync();         // block ends and the slice edges visible

    // ---- unit-start chain, unit ends, prefix hub, new hubs ----
    // every CTA forms the hubs itself from the block ends it gathers, so
    // its copy needs no barrier across the cluster: the same operations on
    // the same values give the same hubs in every CTA
    for (int c = tid; c <= C; c += T)
      qe[c] = word_at(qs, c < C ? uls[c] : (suffix_last >= 0 ? suffix_last
                                                             : 0), s, W, rank);
    __syncthreads();        // the gathered block ends visible
    if constexpr (UPL > 0) {
      // up to 128 units: warp 0 runs the first entry's section on the
      // gathered ends (unit c's end at qe[c], the suffix block's at qe[C])
      if (tid < 32)
        unit_section<UPL>(tid, C, nb, a.n_rounds_c,
                          suffix_last >= 0 ? C : -1, r_unit, ln05, qe, idu,
                          Wut, hubs, hubpos);
    } else if (tid < n_ut) {
      // more units: a unit a thread of as many warps as C needs, each
      // doubling round a barrier among those warps
      for (int c = tid; c < C; c += n_ut) {
        float2 u;
        if (c == 0) {
          const bool has = suffix_last >= 0;
          u = make_float2(has ? qe[C].x : 0.f,
                          __int_as_float(has ? __float_as_int(qe[C].y) : 0));
        } else {
          u = make_float2(qe[c - 1].x + ln05, qe[c - 1].y);
        }
        ub[c] = u;
      }
      int cur = 0;
      for (int r = 0; r < a.n_rounds_c; ++r) {
        const int k = 1 << r;
        if (k >= C) break;
        named_sync(n_ut);
        const float2* from = ub + cur * C;
        float2* to = ub + (cur ^ 1) * C;
        for (int c = tid; c < C; c += n_ut) {
          float2 own = from[c];
          const float2 src = from[c >= k ? c - k : c - k + C];
          const float rv = src.x + Wut[r * C + c];
          if (rv > own.x) own = make_float2(rv, src.y);
          to[c] = own;
        }
        cur ^= 1;
      }
      named_sync(n_ut);
      const float2* us = ub + cur * C;
      // unit ends, and their first-max: the prefix hub
      float pv = -INFINITY;
      int pi = 0x7fffffff, po = 0;
      for (int c = tid; c < C; c += n_ut) {
        const float2 u = us[c];
        float qv = qe[c].x;
        int qo = __float_as_int(qe[c].y);
        pick(qv, qo, u.x + r_unit, __float_as_int(u.y));
        const float key = qv + ln05;
        if (key > pv || (key == pv && c < pi)) { pv = key; pi = c; po = qo; }
        hubs[c + 1] = u.x;
        hubpos[c + 1] = __float_as_int(u.y);
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float v2 = __shfl_down_sync(FULL, pv, off);
        const int i2 = __shfl_down_sync(FULL, pi, off);
        const int o2 = __shfl_down_sync(FULL, po, off);
        if (v2 > pv || (v2 == pv && i2 < pi)) { pv = v2; pi = i2; po = o2; }
      }
      if ((tid & 31) == 0) {
        redv[tid >> 5] = pv; redi[tid >> 5] = pi; redo[tid >> 5] = po;
      }
      named_sync(n_ut);
      pv = redv[0]; pi = redi[0]; po = redo[0];
      for (int w = 1; w < n_uw; ++w)
        if (redv[w] > pv || (redv[w] == pv && redi[w] < pi)) {
          pv = redv[w]; pi = redi[w]; po = redo[w];
        }
      if (tid == 0) { hubs[0] = NEG; hubpos[0] = -1; }
      for (int q = C + 1 + tid; q < nb; q += n_ut) {
        hubs[q] = pv; hubpos[q] = po;
      }
    }
    __syncthreads();        // new hubs visible in this CTA
  }

  // ---- best end score and end state (first max over 2P + nb) ----
  float v = -INFINITY;
  int i = 0x7fffffff;
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const WidePos& q = ps[j];
    if (q.valid) {
      first_max(v, i, q.vM + pos[R_LE_M * P + q.p], q.p);
      first_max(v, i, q.vI + pos[R_LE_I * P + q.p], P + q.p);
    }
  }
  if (rank == 0)
    for (int q = tid; q < nb; q += T)
      first_max(v, i, I0ns[q] + blkt[B_LE_I0 * nb + q], 2 * P + q);
  warp_first_max(v, i);
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) { redv[warp] = v; redi[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = T >> 5;
    v = lane < n_warps ? redv[lane] : -INFINITY;
    i = lane < n_warps ? redi[lane] : 0x7fffffff;
    warp_first_max(v, i);
    if (lane == 0) {
      dsmem(cv, 0)[rank] = v;
      dsmem(ci, 0)[rank] = i;
    }
  }
  cluster_sync();           // every CTA's first max in the first CTA
  if (rank == 0 && tid == 0) {
    v = cv[0]; i = ci[0];
    for (int r = 1; r < n; ++r) first_max(v, i, cv[r], ci[r]);
    a.best[read] = v; a.bstate[read] = i;
  }

  // ---- the exit state: D takes its hub entry here ----
  if (a.exit_f) {
    float* xf = a.exit_f + read * SF;
    int32_t* xi = a.exit_i + read * SI;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const WidePos& q = ps[j];
      if (!q.valid) continue;
      float dc = q.Din;
      int dco = q.Dino;
      pick(dc, dco, hubs[q.blk] + q.hub_d, 2 * P + nb + q.blk);
      xf[q.p] = q.vM; xf[P + q.p] = q.vI;
      xf[2 * P + q.p] = dc; xi[q.p] = dco;
    }
    if (rank == 0)
      for (int q = tid; q < nb; q += T) {
        xf[3 * P + q] = I0ns[q];
        xf[3 * P + nb + q] = hubs[q];
        xi[P + q] = hubpos[q];
      }
  }
}

// Launches the wide entry instantiated for (OT, PPT, UPL, UNITS_OFF);
// with `max_clusters` set it launches nothing and writes there how many of
// its clusters the card holds at once (cudaOccupancyMaxActiveClusters).
template <typename OT, int PPT, int UPL, bool UNITS_OFF = false>
int launch_wide(const FwdArgs& a, int G, int threads, size_t smem,
                cudaStream_t s, int* max_clusters) {
  auto kernel = viterbi_forward_wide_kernel<OT, PPT, UPL, UNITS_OFF>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  if (a.cl_n > 8)
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cl_n * a.B, G);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cl_n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters)
    return (int)cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename OT, int PPT>
int launch_wide_upl(const FwdArgs& a, int G, int threads, size_t smem,
                    cudaStream_t s, int* max_clusters, bool units_off) {
  if (units_off)
    return launch_wide<OT, PPT, 0, true>(a, G, threads, smem, s,
                                         max_clusters);
  switch ((a.C + 31) / 32) {
    case 1: return launch_wide<OT, PPT, 1>(a, G, threads, smem, s,
                                           max_clusters);
    case 2: return launch_wide<OT, PPT, 2>(a, G, threads, smem, s,
                                           max_clusters);
    case 3: return launch_wide<OT, PPT, 3>(a, G, threads, smem, s,
                                           max_clusters);
    case 4: return launch_wide<OT, PPT, MAX_UPL>(a, G, threads, smem, s,
                                                 max_clusters);
    default: return launch_wide<OT, PPT, 0>(a, G, threads, smem, s,
                                            max_clusters);
  }
}

int launch_wide_ppt(const FwdArgs& a, int G, int origin32, int threads,
                    size_t smem, cudaStream_t s, int* max_clusters,
                    bool units_off) {
  if (a.cl_w == threads)
    return origin32 ? launch_wide_upl<int32_t, 1>(a, G, threads, smem, s,
                                                  max_clusters, units_off)
                    : launch_wide_upl<int16_t, 1>(a, G, threads, smem, s,
                                                  max_clusters, units_off);
  return origin32 ? launch_wide_upl<int32_t, 2>(a, G, threads, smem, s,
                                                max_clusters, units_off)
                  : launch_wide_upl<int16_t, 2>(a, G, threads, smem, s,
                                                max_clusters, units_off);
}

// Whether a wide layout keeps its per-unit and per-block arrays in device
// memory: where they do not fit in shared memory beside the slice's.
bool wide_units_off(int slice, int P, int nb, int C, int n_rounds_p,
                    int n_rounds_c) {
  return wide_smem_bytes(slice, P, nb, C, n_rounds_p, n_rounds_c, false) >
         WIDE_SMEM_MAX;
}

template <typename OT, int UPL, bool CARRY>
int launch_carry(const FwdArgs& a, int G, size_t smem, cudaStream_t s) {
  cudaFuncSetAttribute(viterbi_forward_kernel<OT, UPL, CARRY>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int threads = ((a.P + 31) / 32) * 32;
  viterbi_forward_kernel<OT, UPL, CARRY>
      <<<dim3(a.B, G), threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename OT, int UPL>
int launch(const FwdArgs& a, int G, size_t smem, cudaStream_t s) {
  const bool carry = a.entry_f != nullptr || a.exit_f != nullptr ||
                     a.t0 != 0 || a.planes == 0;
  return carry ? launch_carry<OT, UPL, true>(a, G, smem, s)
               : launch_carry<OT, UPL, false>(a, G, smem, s);
}

template <typename OT>
int launch_upl(const FwdArgs& a, int G, size_t smem, cudaStream_t s) {
  switch ((a.C + 31) / 32) {
    case 1: return launch<OT, 1>(a, G, smem, s);
    case 2: return launch<OT, 2>(a, G, smem, s);
    case 3: return launch<OT, 3>(a, G, smem, s);
    default: return launch<OT, MAX_UPL>(a, G, smem, s);
  }
}

}  // namespace

extern "C" {

size_t advntr_forward_smem_bytes(int L, int P, int nb, int C,
                                 int n_rounds_c) {
  return sizeof(float) * (18 * (size_t)P + 3 * (size_t)nb + (size_t)C +
                          (size_t)n_rounds_c * C + 64) + (size_t)L;
}

// Launches B1 for G loci on `stream` over the columns t0 .. t0 + L - 1;
// returns cudaGetLastError() of the launch, or cudaErrorInvalidValue for a
// shape the chosen entry does not take.  `wide` chooses the second entry,
// which runs a cluster of `cluster` CTAs of `threads` threads a read, each
// CTA a slice of `slice` positions (one or two a thread), with `wide_smem`
// bytes of shared memory each and, where the per-unit arrays do not fit
// there, `wide_scratch`: G * B * cluster * wide_unit_words(C, nb) 64-bit
// words of device memory, null otherwise (ops/_kernels.py::wide_layout
// decides them; the first entry ignores them).  The entry state may be null (the reads
// start at column 0), the exit state too (it is not kept); with `planes`
// 0 no origin plane is written and oMI, oXH may be null.
int advntr_viterbi_forward(
    const void* seqs, const void* lengths, const void* pos, const void* blk,
    const void* eM, const void* eI, const void* eI0, const void* Wd,
    const void* Wu, const void* blk_idx, const void* exp_base,
    const void* unit_last, const void* suffix_last, const void* r_unit,
    void* oMI, void* oXH, void* best, void* bstate, const void* entry_f,
    const void* entry_i, void* exit_f, void* exit_i, int G, int B, int L,
    int P, int nb, int C, int n_rounds_p, int n_rounds_c, int origin32,
    int mbit, int t0, int planes, int wide, int cluster, int slice,
    int threads, int wide_smem, void* wide_scratch, float ln05,
    void* stream) {
  const int ppt = threads > 0 ? slice / threads : 0;
  const bool units_off =
      wide && wide_units_off(slice, P, nb, C, n_rounds_p, n_rounds_c);
  if (wide) {
    if (P < 1 || C < 1 || C + 1 > nb || cluster < 1 ||
        cluster > WIDE_MAX_CLUSTER || threads < 32 || threads > 1024 ||
        threads % 32 != 0 || ppt < 1 || ppt > WIDE_MAX_PPT ||
        slice != ppt * threads || (size_t)(cluster - 1) * slice >= (size_t)P ||
        (size_t)cluster * slice < (size_t)P ||
        wide_rounds(P, n_rounds_p) > WIDE_MAX_ROUNDS ||
        (size_t)wide_smem != wide_smem_bytes(slice, P, nb, C, n_rounds_p,
                                             n_rounds_c, units_off) ||
        (size_t)wide_smem > WIDE_SMEM_MAX ||
        (wide_scratch != nullptr) != units_off)
      return (int)cudaErrorInvalidValue;
  } else if (P < 32 || P > 1024 || nb > P || C < 1 ||
             C > 32 * MAX_UPL || C + 1 > nb || n_rounds_p > MAX_ROUNDS) {
    return (int)cudaErrorInvalidValue;
  }
  if ((entry_f == nullptr) != (entry_i == nullptr) ||
      (exit_f == nullptr) != (exit_i == nullptr) ||
      (planes && (oMI == nullptr || oXH == nullptr)))
    return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.seqs = (const int8_t*)seqs; a.lengths = (const int32_t*)lengths;
  a.pos = (const float*)pos; a.blk = (const float*)blk;
  a.eM = (const float*)eM; a.eI = (const float*)eI;
  a.eI0 = (const float*)eI0; a.Wd = (const float*)Wd;
  a.Wu = (const float*)Wu; a.blk_idx = (const int32_t*)blk_idx;
  a.exp_base = (const int32_t*)exp_base;
  a.unit_last = (const int32_t*)unit_last;
  a.suffix_last = (const int32_t*)suffix_last;
  a.r_unit = (const float*)r_unit;
  a.oMI = oMI; a.oXH = oXH;
  a.best = (float*)best; a.bstate = (int32_t*)bstate;
  a.B = B; a.L = L; a.P = P; a.nb = nb; a.C = C;
  a.n_rounds_p = n_rounds_p; a.n_rounds_c = n_rounds_c;
  a.mbit = mbit; a.ln05 = ln05;
  a.entry_f = (const float*)entry_f; a.entry_i = (const int32_t*)entry_i;
  a.exit_f = (float*)exit_f; a.exit_i = (int32_t*)exit_i;
  a.cl_n = cluster; a.cl_w = slice; a.t0 = t0; a.planes = planes;
  a.uscr = (float2*)wide_scratch;
  cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    return launch_wide_ppt(a, G, origin32, threads, wide_smem, s, nullptr,
                           units_off);
  const size_t smem = advntr_forward_smem_bytes(L, P, nb, C, n_rounds_c);
  return origin32 ? launch_upl<int32_t>(a, G, smem, s)
                  : launch_upl<int16_t>(a, G, smem, s);
}

// How many clusters of the wide entry's layout (cluster, slice, threads,
// wide_smem, as advntr_viterbi_forward takes them; `units_off` where the
// per-unit arrays are in device memory) for a model of C units the card
// holds at once, into *out; returns the CUDA error code.
int advntr_forward_wide_max_clusters(int C, int origin32, int cluster,
                                     int slice, int threads, int wide_smem,
                                     int units_off, int* out) {
  FwdArgs a = {};
  a.B = 1; a.C = C; a.cl_n = cluster; a.cl_w = slice;
  return launch_wide_ppt(a, 1, origin32, threads, wide_smem, nullptr, out,
                         units_off != 0);
}

const char* advntr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
