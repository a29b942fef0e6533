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
// viterbi_forward_wide_kernel: still one CTA per (read, locus), but the
// threads stride over the positions and the state, the round buffers and
// the block ends live in a scratch buffer in device memory, which at a few
// hundred KB a read stays in the L2 cache (P 12,288 with its origins does
// not fit the 227 KB of shared memory a block can have).  Every exchange
// between positions goes through that buffer with a block barrier between
// writer and reader, and each doubling round reads one buffer and writes
// the other, so a shift wraps at P exactly as the twin's roll does.  It is
// the twin's column, phase by phase, and gives the first entry's planes
// bit for bit on a model both take.  It is bound by the barriers and the
// L2 round trips of its 20 to 30 phases a column, far above its bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  float* scratch;              // wide entry: (G, B, wide_scratch_words)
  int B, L, P, nb, C, n_rounds_p, n_rounds_c, mbit;
  int t0;                      // the read column of seqs[.., 0]
  int planes;                  // 0: write no origin planes
  float ln05;
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

// ---- the wide entry ------------------------------------------------------

constexpr int WIDE_THREADS = 1024;

// floats of scratch a read takes: M|I twice, D and Do, two round buffers
// and the block ends as (value, origin) pairs, I0 twice, hub and hubpo,
// two unit-chain buffers of pairs
__host__ __device__ inline size_t wide_scratch_words(int P, int nb, int C) {
  return 12 * (size_t)P + 4 * (size_t)nb + 4 * (size_t)C;
}

struct Pair { float v; int o; };   // 8 bytes, stored as one word

__device__ __forceinline__ Pair load_pair(const float2* p) {
  const float2 w = *p;
  return Pair{w.x, __float_as_int(w.y)};
}

__device__ __forceinline__ void store_pair(float2* p, float v, int o) {
  *p = make_float2(v, __int_as_float(o));
}

// first max over the block of (value, index) with a payload: every thread
// returns the winner's value, index and payload
__device__ __forceinline__ void block_first_max(float& v, int& i, int& o,
                                                float* redv, int* redi,
                                                int* redo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_down_sync(FULL, v, off);
    const int i2 = __shfl_down_sync(FULL, i, off);
    const int o2 = __shfl_down_sync(FULL, o, off);
    if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; o = o2; }
  }
  if (lane == 0) { redv[warp] = v; redi[warp] = i; redo[warp] = o; }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    v = lane < n_warps ? redv[lane] : -INFINITY;
    i = lane < n_warps ? redi[lane] : 0x7fffffff;
    o = lane < n_warps ? redo[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_down_sync(FULL, v, off);
      const int i2 = __shfl_down_sync(FULL, i, off);
      const int o2 = __shfl_down_sync(FULL, o, off);
      if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; o = o2; }
    }
    if (lane == 0) { redv[32] = v; redi[32] = i; redo[32] = o; }
  }
  __syncthreads();
  v = redv[32]; i = redi[32]; o = redo[32];
  __syncthreads();          // the buffers may be written again
}

template <typename OT>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
viterbi_forward_wide_kernel(const FwdArgs a) {
  const int P = a.P, nb = a.nb, C = a.C, L = a.L;
  const int b = blockIdx.x, g = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;

  const float* pos = a.pos + (size_t)g * N_POS_ROWS * P;
  const float* blkt = a.blk + (size_t)g * N_BLK_ROWS * nb;
  const float* eM = a.eM + (size_t)g * P * 4;
  const float* eI = a.eI + (size_t)g * P * 4;
  const float* eI0 = a.eI0 + (size_t)g * nb * 4;
  const float* Wd = a.Wd + (size_t)g * a.n_rounds_p * P;
  const float* Wu = a.Wu + (size_t)g * a.n_rounds_c * C;
  const int32_t* blk_idx = a.blk_idx + (size_t)g * P;
  const int32_t* exp_base = a.exp_base + (size_t)g * P;
  const int32_t* uls = a.unit_last + (size_t)g * C;
  const int suffix_last = a.suffix_last[g];
  const float r_unit = a.r_unit[g];
  const float ln05 = a.ln05;
  const size_t read = (size_t)g * a.B + b;
  const int len = a.lengths[read];
  const bool planes = a.planes != 0;

  // this read's scratch
  float* sc = a.scratch + read * wide_scratch_words(P, nb, C);
  float* MIb[2] = {sc, sc + 2 * P};             // M|I, old and new
  float* Dv = sc + 4 * P;                       // D after its hub entry
  int* Do = (int*)(sc + 5 * P);
  float2* Dr[2] = {(float2*)(sc + 6 * P), (float2*)(sc + 8 * P)};
  float2* qs = (float2*)(sc + 10 * P);          // block ends
  float* bs = sc + 12 * P;
  float* I0b[2] = {bs, bs + nb};
  float* hub = bs + 2 * nb;
  int* hubpo = (int*)(bs + 3 * nb);
  float2* us[2] = {(float2*)(bs + 4 * nb), (float2*)(bs + 4 * nb + 2 * C)};

  __shared__ float redv[33];
  __shared__ int redi[33];
  __shared__ int redo[33];
  extern __shared__ int8_t seq_w[];             // L: the read, clipped

  const int SF = 3 * P + 2 * nb, SI = P + nb;
  const float* ef = a.entry_f ? a.entry_f + read * SF : nullptr;
  const int32_t* ei = a.entry_i ? a.entry_i + read * SI : nullptr;
  for (int p = tid; p < P; p += nt) {
    MIb[0][p] = ef ? ef[p] : NEG;
    MIb[0][P + p] = ef ? ef[P + p] : NEG;
    Dv[p] = ef ? ef[2 * P + p] : NEG;
    Do[p] = ei ? ei[p] : 0;
  }
  for (int q = tid; q < nb; q += nt) {
    I0b[0][q] = ef ? ef[3 * P + q] : NEG;
    hub[q] = ef ? ef[3 * P + nb + q] : NEG;
    hubpo[q] = ei ? ei[P + q] : 0;
  }
  for (int i = tid; i < L; i += nt) {
    const int base = a.seqs[read * L + i];
    seq_w[i] = (int8_t)(base < 0 ? 0 : (base > 3 ? 3 : base));
  }
  int cur = 0;                  // the buffer that holds M|I and I0
  __syncthreads();

  for (int t = 0; t < L; ++t) {
    const int base = seq_w[t];
    const int tg = a.t0 + t;
    const bool act = tg < len;
    if (!act && !planes) break;
    const float* MI = MIb[cur];
    const float* I0 = I0b[cur];
    float* MIn = MIb[cur ^ 1];
    float* I0n = I0b[cur ^ 1];

    // ---- emitting layer: sources from the previous column ----
    OT* pMI = planes
        ? (OT*)a.oMI + (((size_t)g * L + t) * a.B + b) * 2 * P : nullptr;
    for (int p = tid; p < P; p += nt) {
      const int tp = p == 0 ? P - 1 : p - 1;
      const int blk = blk_idx[p];
      const int blkcode = 2 * P + blk, hubsent = blkcode + nb;
      const float eMv = eM[p * 4 + base], eIv = eI[p * 4 + base];
      float nM, nI;
      int oM, oI;
      if (tg == 0) {
        nM = pos[R_M_START * P + p] + eMv;
        nI = pos[R_I_START * P + p] + eIv;
        oM = -1; oI = -1;
      } else {
        float v5 = hub[blk] + pos[R_ENT_M * P + p];
        int o5 = hubsent;
        pick(v5, o5, I0[blk] + pos[R_I0_M * P + p], blkcode);
        // the roll of the concatenated M|I row: position 0 takes I_{P-1}
        // where the others take M_{p-1}, and M_{P-1} for I_{p-1}
        const float mnb = p == 0 ? MI[2 * P - 1] : MI[p - 1];
        const float inb = p == 0 ? MI[P - 1] : MI[P + p - 1];
        float v = mnb + pos[R_A_MM * P + p];
        int o = p - 1;
        pick(v, o, inb + pos[R_A_IM * P + p], P + p - 1);
        pick(v, o, Dv[tp] + pos[R_A_DM * P + p], Do[tp]);
        pick(v, o, v5, o5);
        nM = eMv + v; oM = o;
        float w = MI[p] + pos[R_MI * P + p];
        int ow = p;
        pick(w, ow, MI[P + p] + pos[R_II * P + p], P + p);
        pick(w, ow, Dv[p] + pos[R_DI * P + p], Do[p]);
        pick(w, ow, NEG, o5);
        nI = eIv + w; oI = ow;
      }
      if (planes) {
        pMI[p] = (OT)(oM + 1 + (base == exp_base[p] ? a.mbit : 0));
        pMI[P + p] = (OT)(oI + 1);
      }
      if (act) { MIn[p] = nM; MIn[P + p] = nI; }
    }
    for (int q = tid; q < nb; q += nt) {
      const float e0 = eI0[q * 4 + base];
      float v0;
      int o0;
      if (tg == 0) {
        v0 = blkt[B_I0_START * nb + q] + e0; o0 = -1;
      } else {
        v0 = I0[q] + blkt[B_I0_I * nb + q]; o0 = 2 * P + q;
        pick(v0, o0, hub[q] + blkt[B_HUB_I0 * nb + q], 2 * P + nb + q);
        v0 = e0 + v0;
      }
      if (planes) {
        OT* pXH = (OT*)a.oXH + (((size_t)g * L + t) * a.B + b) * 2 * nb;
        pXH[q] = (OT)(o0 + 1);
        pXH[nb + q] = (OT)(hubpo[q] + 1);
      }
      if (act) I0n[q] = v0;
    }
    if (!act) continue;     // length freeze: the state stays as it is
    cur ^= 1;
    MI = MIn; I0 = I0n;
    __syncthreads();        // new M|I and I0 visible

    // ---- delete chain: D_j = max(D_{j-1} + dd_j, b_j), by doubling ----
    for (int p = tid; p < P; p += nt) {
      const int blk = blk_idx[p];
      const float mnb = p == 0 ? MI[2 * P - 1] : MI[p - 1];
      const float inb = p == 0 ? MI[P - 1] : MI[P + p - 1];
      float Din = mnb + pos[R_MD * P + p];
      int Dino = p - 1;
      pick(Din, Dino, inb + pos[R_IDW * P + p], P + p - 1);
      pick(Din, Dino, I0[blk] + pos[R_I0_D * P + p], 2 * P + blk);
      store_pair(&Dr[0][p], Din, Dino);
    }
    int db = 0;
    for (int r = 0; r < a.n_rounds_p; ++r) {
      const int k = 1 << r;
      if (k >= P) break;
      __syncthreads();      // the round's input is whole
      for (int p = tid; p < P; p += nt) {
        Pair own = load_pair(&Dr[db][p]);
        const Pair src = load_pair(&Dr[db][p >= k ? p - k : p - k + P]);
        const float rv = src.v + Wd[(size_t)r * P + p];
        if (rv > own.v) { own.v = rv; own.o = src.o; }
        store_pair(&Dr[db ^ 1][p], own.v, own.o);
      }
      db ^= 1;
    }

    // ---- block-end extraction (a thread reads what it wrote) ----
    for (int p = tid; p < P; p += nt) {
      const Pair d = load_pair(&Dr[db][p]);
      float qv = MI[p] + pos[R_XM * P + p];
      int qo = p;
      pick(qv, qo, MI[P + p] + pos[R_XI * P + p], P + p);
      pick(qv, qo, d.v + pos[R_XD * P + p], d.o);
      store_pair(&qs[p], qv, qo);
    }
    __syncthreads();        // block ends visible

    // ---- unit-start chain, unit ends, prefix hub ----
    for (int c = tid; c < C; c += nt) {
      if (c == 0) {
        const bool has = suffix_last >= 0;
        const Pair e = load_pair(&qs[has ? suffix_last : 0]);
        store_pair(&us[0][0], has ? e.v : 0.f, has ? e.o : 0);
      } else {
        const Pair e = load_pair(&qs[uls[c - 1]]);
        store_pair(&us[0][c], e.v + ln05, e.o);
      }
    }
    int ub = 0;
    for (int r = 0; r < a.n_rounds_c; ++r) {
      const int k = 1 << r;
      if (k >= C) break;
      __syncthreads();
      for (int c = tid; c < C; c += nt) {
        Pair own = load_pair(&us[ub][c]);
        const Pair src = load_pair(&us[ub][c >= k ? c - k : c - k + C]);
        const float rv = src.v + Wu[r * C + c];
        if (rv > own.v) { own.v = rv; own.o = src.o; }
        store_pair(&us[ub ^ 1][c], own.v, own.o);
      }
      ub ^= 1;
    }
    float pv = -INFINITY;
    int pi = 0x7fffffff, po = 0;
    for (int c = tid; c < C; c += nt) {
      const Pair u = load_pair(&us[ub][c]);
      Pair e = load_pair(&qs[uls[c]]);
      pick(e.v, e.o, u.v + r_unit, u.o);
      const float key = e.v + ln05;
      if (key > pv || (key == pv && c < pi)) { pv = key; pi = c; po = e.o; }
    }
    block_first_max(pv, pi, po, redv, redi, redo);

    // ---- new hubs: none for the suffix block, unit starts, prefix hub ----
    for (int q = tid; q < nb; q += nt) {
      if (q == 0) {
        hub[0] = NEG; hubpo[0] = -1;
      } else if (q <= C) {
        const Pair u = load_pair(&us[ub][q - 1]);
        hub[q] = u.v; hubpo[q] = u.o;
      } else {
        hub[q] = pv; hubpo[q] = po;
      }
    }
    __syncthreads();        // new hubs visible

    // ---- the hub entry of the delete chain ----
    for (int p = tid; p < P; p += nt) {
      const int blk = blk_idx[p];
      Pair d = load_pair(&Dr[db][p]);
      pick(d.v, d.o, hub[blk] + pos[R_HUB_D * P + p], 2 * P + nb + blk);
      Dv[p] = d.v; Do[p] = d.o;
    }
    __syncthreads();        // D visible to the position above
  }

  // ---- best end score and end state (first max over 2P + nb) ----
  const float* MI = MIb[cur];
  const float* I0 = I0b[cur];
  float v = -INFINITY;
  int i = 0x7fffffff, unused = 0;
  for (int p = tid; p < P; p += nt) {
    first_max(v, i, MI[p] + pos[R_LE_M * P + p], p);
    first_max(v, i, MI[P + p] + pos[R_LE_I * P + p], P + p);
  }
  for (int q = tid; q < nb; q += nt)
    first_max(v, i, I0[q] + blkt[B_LE_I0 * nb + q], 2 * P + q);
  block_first_max(v, i, unused, redv, redi, redo);
  if (tid == 0) { a.best[read] = v; a.bstate[read] = i; }

  if (a.exit_f) {
    float* xf = a.exit_f + read * SF;
    int32_t* xi = a.exit_i + read * SI;
    for (int p = tid; p < P; p += nt) {
      xf[p] = MI[p]; xf[P + p] = MI[P + p];
      xf[2 * P + p] = Dv[p]; xi[p] = Do[p];
    }
    for (int q = tid; q < nb; q += nt) {
      xf[3 * P + q] = I0[q];
      xf[3 * P + nb + q] = hub[q];
      xi[P + q] = hubpo[q];
    }
  }
}

template <typename OT>
int launch_wide(const FwdArgs& a, int G, cudaStream_t s) {
  const size_t smem = (size_t)a.L;
  cudaFuncSetAttribute(viterbi_forward_wide_kernel<OT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int rounded = ((a.P + 31) / 32) * 32;
  const int threads = rounded < WIDE_THREADS ? rounded : WIDE_THREADS;
  viterbi_forward_wide_kernel<OT><<<dim3(a.B, G), threads, smem, s>>>(a);
  return (int)cudaGetLastError();
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

size_t advntr_forward_wide_scratch_words(int P, int nb, int C) {
  return wide_scratch_words(P, nb, C);
}

// Launches B1 for G loci on `stream` over the columns t0 .. t0 + L - 1;
// returns cudaGetLastError() of the launch, or cudaErrorInvalidValue for a
// shape the chosen entry does not take.  `wide` chooses the second entry,
// which takes any P and C and needs `scratch`.  The entry state may be
// null (the reads start at column 0), the exit state too (it is not
// kept); with `planes` 0 no origin plane is written and oMI, oXH may be
// null.
int advntr_viterbi_forward(
    const void* seqs, const void* lengths, const void* pos, const void* blk,
    const void* eM, const void* eI, const void* eI0, const void* Wd,
    const void* Wu, const void* blk_idx, const void* exp_base,
    const void* unit_last, const void* suffix_last, const void* r_unit,
    void* oMI, void* oXH, void* best, void* bstate, const void* entry_f,
    const void* entry_i, void* exit_f, void* exit_i, void* scratch, int G,
    int B, int L, int P, int nb, int C, int n_rounds_p, int n_rounds_c,
    int origin32, int mbit, int t0, int planes, int wide, float ln05,
    void* stream) {
  if (wide) {
    if (P < 1 || C < 1 || C + 1 > nb || scratch == nullptr)
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
  a.scratch = (float*)scratch; a.t0 = t0; a.planes = planes;
  cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    return origin32 ? launch_wide<int32_t>(a, G, s)
                    : launch_wide<int16_t>(a, G, s);
  const size_t smem = advntr_forward_smem_bytes(L, P, nb, C, n_rounds_c);
  return origin32 ? launch_upl<int32_t>(a, G, smem, s)
                  : launch_upl<int16_t>(a, G, smem, s);
}

const char* advntr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
