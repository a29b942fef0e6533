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
  int B, L, P, nb, C, n_rounds_p, n_rounds_c, mbit;
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

template <typename OT, int UPL>
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
  if (is_blk) { hubs[tid] = NEG; hubpos[tid] = 0; I0ns[tid] = NEG; }
  if (is_pos) {
    // emissions by base first, so a column's read is one coalesced load
#pragma unroll
    for (int c = 0; c < 4; ++c)
      ems[c * P + tid] = make_float2(eM[tid * 4 + c], eI[tid * 4 + c]);
  }
  if (is_pos) Dps[tid] = make_float2(NEG, __int_as_float(0));
  if (tid < C) uls[tid] = a.unit_last[(size_t)g * C + tid];
  for (int i = tid; i < a.n_rounds_c * C; i += blockDim.x) Wus[i] = Wu[i];
  for (int i = tid; i < L; i += blockDim.x) {
    const int base = a.seqs[read * L + i];
    seq_s[i] = (int8_t)(base < 0 ? 0 : (base > 3 ? 3 : base));
  }
  const int len = a.lengths[read];
  // this thread's entries of the read's plane rows, one column apart
  const size_t colMI = (size_t)a.B * 2 * P;
  OT* pMI = (OT*)a.oMI + ((size_t)g * L * a.B + b) * 2 * P + p;

  // the DP state a thread carries from column to column
  float vM = NEG, vI = NEG;     // M_p, I_p
  float mnb = NEG, inb = NEG;   // the rolled sources of M_p (M_{p-1}, I_{p-1})
  float Din = NEG;              // D_p before its hub entry, and its origin
  int Dino = 0;
  float i0_blk = NEG;           // I0 of p's block
  __syncthreads();

  for (int t = 0; t < L; ++t) {
    const int base = seq_s[t];
    const bool act = t < len;

    // ---- emitting layer: sources from the previous column ----
    {
      const float2 em = ems[base * P + p];
      const float eMv = em.x, eIv = em.y;
      float nM, nI;
      int oM, oI;
      if (t == 0) {
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
      if (is_pos) {
        pMI[0] = (OT)(oM + 1 + (base == expb ? a.mbit : 0));
        pMI[P] = (OT)(oI + 1);
      }
      pMI += colMI;
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
      if (t == 0) {
        v0 = blkt[B_I0_START * nb + tid] + e0; o0 = -1;
      } else {
        v0 = I0ns[tid] + blkt[B_I0_I * nb + tid]; o0 = 2 * P + tid;
        pick(v0, o0, hubs[tid] + blkt[B_HUB_I0 * nb + tid],
             2 * P + nb + tid);
        v0 = e0 + v0;
      }
      OT* pXH = (OT*)a.oXH + (((size_t)g * L + t) * a.B + b) * 2 * nb + tid;
      pXH[0] = (OT)(o0 + 1);
      pXH[nb] = (OT)(hubpos[tid] + 1);
      if (act) I0ns[tid] = v0;
    }
    if (!act) continue;     // length freeze: the state stays as it is
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
}

template <typename OT, int UPL>
int launch(const FwdArgs& a, int G, size_t smem, cudaStream_t s) {
  cudaFuncSetAttribute(viterbi_forward_kernel<OT, UPL>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int threads = ((a.P + 31) / 32) * 32;
  viterbi_forward_kernel<OT, UPL><<<dim3(a.B, G), threads, smem, s>>>(a);
  return (int)cudaGetLastError();
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

// Launches B1 for G loci on `stream`; returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for a shape the kernel does not take.
int advntr_viterbi_forward(
    const void* seqs, const void* lengths, const void* pos, const void* blk,
    const void* eM, const void* eI, const void* eI0, const void* Wd,
    const void* Wu, const void* blk_idx, const void* exp_base,
    const void* unit_last, const void* suffix_last, const void* r_unit,
    void* oMI, void* oXH, void* best, void* bstate, int G, int B, int L,
    int P, int nb, int C, int n_rounds_p, int n_rounds_c, int origin32,
    int mbit, float ln05, void* stream) {
  if (P < 32 || P > 1024 || nb > P || C < 1 ||
      C > 32 * MAX_UPL || C + 1 > nb || n_rounds_p > MAX_ROUNDS)
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
  const size_t smem = advntr_forward_smem_bytes(L, P, nb, C, n_rounds_c);
  cudaStream_t s = (cudaStream_t)stream;
  return origin32 ? launch_upl<int32_t>(a, G, smem, s)
                  : launch_upl<int16_t>(a, G, smem, s);
}

const char* advntr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
