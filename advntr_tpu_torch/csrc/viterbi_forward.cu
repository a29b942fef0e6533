// B1: fused structured-Viterbi forward with argmax provenance.
//
// Replaces the TPU kernel advntr_tpu/ops/pallas_viterbi.py::_fused_kernel
// (launched by pallas_fused_forward).  The plain PyTorch twin is
// advntr_tpu_torch/ops/viterbi_fused.py::fused_forward_reference; this
// kernel computes the same float32 sums in the same order and breaks every
// tie the same way (the first candidate wins a pick; the lowest index wins
// an argmax), so both give the same planes.
//
// What bounds it on an H100.  The bytes: each read writes L * (2P + 2nb)
// origin codes, 1.39 GB of int16 at B=4096, L=160, P=512 (1.34 GB of it
// oMI), against a few hundred KB of model tables that stay in L1/L2; at
// 3.35 TB/s that is a floor of about 0.4 ms.  The column loop: every
// column is serial, with about 20 block-wide barriers (8 delete-chain
// rounds, 4 unit-chain rounds, the fixed phases), and the kernel measured
// about 25x the byte floor (PERF.md), so the barriers, not the stores, are
// the likely limit.  The design: one CTA per read and one thread per match
// position p, so each column's plane row is written by P consecutive
// threads as one coalesced store straight to device memory, and nothing
// but the DP state (about 12P words) lives on chip.  Emissions are a table
// lookup eM[p, base]; the delete chain and the unit-start chain are the
// reference's log-doubling shift-max rounds over the precomputed windows
// Wd/Wu, one barrier per round.  Later work: several reads per CTA, and
// fewer barriers per column.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;

// rows of the per-position float table: the order of POS_ROWS in
// advntr_tpu_torch/ops/struct_model.py
enum {
  R_A_MM, R_A_IM, R_A_DM, R_ENT_M, R_I0_M, R_MI, R_II, R_DI, R_MD, R_IDW,
  R_I0_D, R_HUB_D, R_XM, R_XI, R_XD, R_M_START, R_I_START, R_LE_M, R_LE_I
};
// rows of the per-block float table (BLK_ROWS)
enum { B_I0_I, B_HUB_I0, B_I0_START, B_LE_I0 };

struct FwdArgs {
  const int8_t* seqs;       // (B, L)
  const int32_t* lengths;   // (B,)
  const float* pos;         // (19, P)
  const float* blk;         // (4, nb)
  const float* eM;          // (P, 4)
  const float* eI;          // (P, 4)
  const float* eI0;         // (nb, 4)
  const float* Wd;          // (n_rounds_p, P)
  const float* Wu;          // (n_rounds_c, C)
  const int32_t* blk_idx;   // (P,)
  const int32_t* exp_base;  // (P,)
  const int32_t* unit_last; // (C,)
  void* oMI;                // (L, B, 2P) int16 or int32
  void* oXH;                // (L, B, 2nb)
  float* best;              // (B,)
  int32_t* bstate;          // (B,)
  int B, L, P, nb, C, n_rounds_p, n_rounds_c, suffix_last, mbit;
  float r_unit, ln05;
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

__device__ __forceinline__ void warp_first_max(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    float v2 = __shfl_down_sync(0xffffffffu, v, off);
    int i2 = __shfl_down_sync(0xffffffffu, i, off);
    first_max(v, i, v2, i2);
  }
}

template <typename OT>
__global__ void __launch_bounds__(1024)
viterbi_forward_kernel(const FwdArgs a) {
  const int P = a.P, nb = a.nb, C = a.C, L = a.L;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const bool is_pos = tid < P;
  const bool is_blk = tid < nb;

  extern __shared__ float smem[];
  float* MIa = smem;                     // 2P: previous column M|I
  float* MIb = MIa + 2 * P;              // 2P: new column M|I
  float* Ds = MIb + 2 * P;               // P: D values
  int* Dos = (int*)(Ds + P);             // P: D origins
  float* Dv0 = (float*)(Dos + P);        // 2 x P: delete-chain buffers
  float* Dv1 = Dv0 + P;
  int* Do0 = (int*)(Dv1 + P);
  int* Do1 = Do0 + P;
  float* qvs = (float*)(Do1 + P);        // P: block-end extraction
  int* qos = (int*)(qvs + P);
  float* I0s = (float*)(qos + P);        // nb each below
  float* hubs = I0s + nb;
  int* hubpos = (int*)(hubs + nb);
  float* I0ns = (float*)(hubpos + nb);
  float* hubus = I0ns + nb;
  int* hubous = (int*)(hubus + nb);
  float* us0 = (float*)(hubous + nb);    // C each below
  float* us1 = us0 + C;
  int* uo0 = (int*)(us1 + C);
  int* uo1 = uo0 + C;
  float* uev = (float*)(uo1 + C);
  int* ueo = (int*)(uev + C);
  float* redv = (float*)(ueo + C);       // 32 + 1
  int* redi = (int*)(redv + 33);         // 32 + 1

  // per-position constants in registers
  float a_mm = 0, a_im = 0, a_dm = 0, ent_m = 0, i0_m = 0, mi = 0, ii = 0,
        di = 0, md = 0, idw = 0, i0_d = 0, hub_d = 0, xm = 0, xi = 0,
        xd = 0, m_start = 0, i_start = 0;
  int blk = 0, expb = -1;
  if (is_pos) {
    const float* r = a.pos + tid;
    a_mm = r[R_A_MM * P]; a_im = r[R_A_IM * P]; a_dm = r[R_A_DM * P];
    ent_m = r[R_ENT_M * P]; i0_m = r[R_I0_M * P]; mi = r[R_MI * P];
    ii = r[R_II * P]; di = r[R_DI * P]; md = r[R_MD * P];
    idw = r[R_IDW * P]; i0_d = r[R_I0_D * P]; hub_d = r[R_HUB_D * P];
    xm = r[R_XM * P]; xi = r[R_XI * P]; xd = r[R_XD * P];
    m_start = r[R_M_START * P]; i_start = r[R_I_START * P];
    blk = a.blk_idx[tid];
    expb = a.exp_base[tid];
    MIa[tid] = NEG; MIa[P + tid] = NEG;
    Ds[tid] = NEG; Dos[tid] = 0;
  }
  const int blkcode = 2 * P + blk;        // I0 origin code of p's block
  const int hubsent = blkcode + nb;       // hub sentinel of p's block
  float i0_i = 0, hub_i0 = 0, i0_start = 0;
  if (is_blk) {
    i0_i = a.blk[B_I0_I * nb + tid];
    hub_i0 = a.blk[B_HUB_I0 * nb + tid];
    i0_start = a.blk[B_I0_START * nb + tid];
    I0s[tid] = NEG; hubs[tid] = NEG; hubpos[tid] = 0;
  }
  const int len = a.lengths[b];
  const size_t rowMI = 2 * (size_t)P, rowXH = 2 * (size_t)nb;
  OT* oMI = (OT*)a.oMI;
  OT* oXH = (OT*)a.oXH;
  float* MIp = MIa;   // previous column
  float* MIn = MIb;   // column being computed
  __syncthreads();

  for (int t = 0; t < L; ++t) {
    int base = a.seqs[(size_t)b * L + t];
    base = base < 0 ? 0 : (base > 3 ? 3 : base);
    const bool act = t < len;
    const size_t plane = (size_t)t * a.B + b;

    // ---- emitting layer: sources from the previous column ----
    if (is_pos) {
      const float eMv = a.eM[tid * 4 + base], eIv = a.eI[tid * 4 + base];
      float vM, vI;
      int oM, oI;
      if (t == 0) {
        vM = m_start + eMv; vI = i_start + eIv; oM = -1; oI = -1;
      } else {
        float v5 = hubs[blk] + ent_m;
        int o5 = hubsent;
        pick(v5, o5, I0s[blk] + i0_m, blkcode);
        // shifted sources wrap like the reference's lane roll; the
        // weights at block starts are NEG, so a wrapped value can only
        // reach a state no finite path uses, exactly as in the reference
        const int pm = tid == 0 ? 2 * P - 1 : tid - 1;
        const int pd = tid == 0 ? P - 1 : tid - 1;
        float v = MIp[pm] + a_mm;
        int o = tid - 1;
        pick(v, o, MIp[P + tid - 1] + a_im, P + tid - 1);
        pick(v, o, Ds[pd] + a_dm, Dos[pd]);
        pick(v, o, v5, o5);
        vM = eMv + v; oM = o;
        float w = MIp[tid] + mi;
        int ow = tid;
        pick(w, ow, MIp[P + tid] + ii, P + tid);
        pick(w, ow, Ds[tid] + di, Dos[tid]);
        pick(w, ow, NEG, o5);
        vI = eIv + w; oI = ow;
      }
      if (!act) { vM = MIp[tid]; vI = MIp[P + tid]; }   // length freeze
      MIn[tid] = vM;
      MIn[P + tid] = vI;
      oMI[plane * rowMI + tid] = (OT)(oM + 1 + (base == expb ? a.mbit : 0));
      oMI[plane * rowMI + P + tid] = (OT)(oI + 1);
    }
    if (is_blk) {
      float v0;
      int o0;
      if (t == 0) {
        v0 = i0_start + a.eI0[tid * 4 + base]; o0 = -1;
      } else {
        v0 = I0s[tid] + i0_i; o0 = 2 * P + tid;
        pick(v0, o0, hubs[tid] + hub_i0, 2 * P + nb + tid);
        v0 = a.eI0[tid * 4 + base] + v0;
      }
      if (!act) v0 = I0s[tid];
      I0ns[tid] = v0;
      oXH[plane * rowXH + tid] = (OT)(o0 + 1);
      oXH[plane * rowXH + nb + tid] = (OT)(hubpos[tid] + 1);
    }
    __syncthreads();

    // ---- delete chain: D_j = max(D_{j-1} + dd_j, b_j), by doubling ----
    float Din = NEG;
    int Dino = 0;
    if (is_pos) {
      const int pm = tid == 0 ? 2 * P - 1 : tid - 1;
      Din = MIn[pm] + md; Dino = tid - 1;
      pick(Din, Dino, MIn[P + tid - 1] + idw, P + tid - 1);
      pick(Din, Dino, I0ns[blk] + i0_d, blkcode);
      Dv0[tid] = Din; Do0[tid] = Dino;
    }
    __syncthreads();
    float* Dsrc = Dv0; float* Ddst = Dv1;
    int* Osrc = Do0; int* Odst = Do1;
    for (int r = 0; r < a.n_rounds_p; ++r) {
      const int k = 1 << r;
      if (k >= P) break;
      if (is_pos) {
        const int src = tid >= k ? tid - k : tid - k + P;
        const float rv = Dsrc[src] + a.Wd[r * P + tid];
        if (rv > Din) { Din = rv; Dino = Osrc[src]; }
        Ddst[tid] = Din; Odst[tid] = Dino;
      }
      float* tf = Dsrc; Dsrc = Ddst; Ddst = tf;
      int* ti = Osrc; Osrc = Odst; Odst = ti;
      __syncthreads();
    }

    // ---- block-end extraction ----
    if (is_pos) {
      float qv = MIn[tid] + xm;
      int qo = tid;
      pick(qv, qo, MIn[P + tid] + xi, P + tid);
      pick(qv, qo, Din + xd, Dino);
      qvs[tid] = qv; qos[tid] = qo;
    }
    __syncthreads();

    // ---- unit-start chain over the C units ----
    if (tid < C) {
      float s;
      int so;
      if (tid == 0) {
        const bool has = a.suffix_last >= 0;
        s = has ? qvs[a.suffix_last] : 0.f;
        so = has ? qos[a.suffix_last] : 0;
      } else {
        const int ul = a.unit_last[tid - 1];
        s = qvs[ul] + a.ln05; so = qos[ul];
      }
      us0[tid] = s; uo0[tid] = so;
    }
    __syncthreads();
    float* Usrc = us0; float* Udst = us1;
    int* UOsrc = uo0; int* UOdst = uo1;
    for (int r = 0; r < a.n_rounds_c; ++r) {
      const int k = 1 << r;
      if (k >= C) break;
      if (tid < C) {
        const int src = tid >= k ? tid - k : tid - k + C;
        float v = Usrc[tid];
        int o = UOsrc[tid];
        pick(v, o, Usrc[src] + a.Wu[r * C + tid], UOsrc[src]);
        Udst[tid] = v; UOdst[tid] = o;
      }
      float* tf = Usrc; Usrc = Udst; Udst = tf;
      int* ti = UOsrc; UOsrc = UOdst; UOdst = ti;
      __syncthreads();
    }
    if (tid < C) {
      const int ul = a.unit_last[tid];
      float q = qvs[ul];
      int qo = qos[ul];
      pick(q, qo, Usrc[tid] + a.r_unit, UOsrc[tid]);
      uev[tid] = q + a.ln05; ueo[tid] = qo;
    }
    __syncthreads();
    if (tid < 32) {      // first-max over the units: the prefix hub
      float v = -INFINITY;
      int i = 0x7fffffff;
      for (int c = tid; c < C; c += 32) first_max(v, i, uev[c], c);
      warp_first_max(v, i);
      if (tid == 0) { redv[32] = v; redi[32] = ueo[i]; }
    }
    __syncthreads();

    // ---- new hubs, then the hub entries of the delete chain ----
    if (is_blk) {
      float hv;
      int ho;
      if (tid == 0) { hv = NEG; ho = -1; }
      else if (tid <= C) { hv = Usrc[tid - 1]; ho = UOsrc[tid - 1]; }
      else { hv = redv[32]; ho = redi[32]; }
      hubus[tid] = hv; hubous[tid] = ho;
    }
    __syncthreads();
    if (is_pos) {
      pick(Din, Dino, hubus[blk] + hub_d, hubsent);
      if (act) { Ds[tid] = Din; Dos[tid] = Dino; }
    }
    if (is_blk) {
      I0s[tid] = I0ns[tid];
      if (act) { hubs[tid] = hubus[tid]; hubpos[tid] = hubous[tid]; }
    }
    float* tf = MIp; MIp = MIn; MIn = tf;
    __syncthreads();
  }

  // ---- best end score and end state (first max over 2P + nb) ----
  float v = -INFINITY;
  int i = 0x7fffffff;
  if (is_pos) {
    first_max(v, i, MIp[tid] + a.pos[R_LE_M * P + tid], tid);
    first_max(v, i, MIp[P + tid] + a.pos[R_LE_I * P + tid], P + tid);
  }
  if (is_blk)
    first_max(v, i, I0s[tid] + a.blk[B_LE_I0 * nb + tid], 2 * P + tid);
  warp_first_max(v, i);
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) { redv[warp] = v; redi[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    v = lane < n_warps ? redv[lane] : -INFINITY;
    i = lane < n_warps ? redi[lane] : 0x7fffffff;
    warp_first_max(v, i);
    if (lane == 0) { a.best[b] = v; a.bstate[b] = i; }
  }
}

}  // namespace

extern "C" {

size_t advntr_forward_smem_bytes(int P, int nb, int C) {
  return sizeof(float) * (12 * (size_t)P + 6 * (size_t)nb + 6 * (size_t)C +
                          66);
}

// Launches B1 on `stream`; returns cudaGetLastError() of the launch.
int advntr_viterbi_forward(
    const void* seqs, const void* lengths, const void* pos, const void* blk,
    const void* eM, const void* eI, const void* eI0, const void* Wd,
    const void* Wu, const void* blk_idx, const void* exp_base,
    const void* unit_last, void* oMI, void* oXH, void* best, void* bstate,
    int B, int L, int P, int nb, int C, int n_rounds_p, int n_rounds_c,
    int suffix_last, int origin32, int mbit, float r_unit, float ln05,
    void* stream) {
  FwdArgs a;
  a.seqs = (const int8_t*)seqs; a.lengths = (const int32_t*)lengths;
  a.pos = (const float*)pos; a.blk = (const float*)blk;
  a.eM = (const float*)eM; a.eI = (const float*)eI;
  a.eI0 = (const float*)eI0; a.Wd = (const float*)Wd;
  a.Wu = (const float*)Wu; a.blk_idx = (const int32_t*)blk_idx;
  a.exp_base = (const int32_t*)exp_base;
  a.unit_last = (const int32_t*)unit_last;
  a.oMI = oMI; a.oXH = oXH;
  a.best = (float*)best; a.bstate = (int32_t*)bstate;
  a.B = B; a.L = L; a.P = P; a.nb = nb; a.C = C;
  a.n_rounds_p = n_rounds_p; a.n_rounds_c = n_rounds_c;
  a.suffix_last = suffix_last; a.mbit = mbit;
  a.r_unit = r_unit; a.ln05 = ln05;
  int lanes = P > nb ? P : nb;
  int threads = ((lanes + 31) / 32) * 32;
  size_t smem = advntr_forward_smem_bytes(P, nb, C);
  cudaStream_t s = (cudaStream_t)stream;
  if (origin32) {
    cudaFuncSetAttribute(viterbi_forward_kernel<int32_t>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    viterbi_forward_kernel<int32_t><<<B, threads, smem, s>>>(a);
  } else {
    cudaFuncSetAttribute(viterbi_forward_kernel<int16_t>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    viterbi_forward_kernel<int16_t><<<B, threads, smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}

const char* advntr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
