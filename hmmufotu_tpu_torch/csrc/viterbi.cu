// K1 and K4: the banded profile-HMM Viterbi DP, one kernel body in two
// modes, as the Pallas `_viterbi_kernel` is one body with `traced`.
//
// K1 hm_viterbi_traced replaces hmmufotu_tpu/hmm/pallas_viterbi.py
// `_viterbi_kernel` in its traced mode (viterbi_pallas_traced /
// _viterbi_split_jit): the traceback runs in the kernel.  Output contract
// is identical: one [8 + TPS] int32 comb row per read — the f32 bits of
// (score, best_i, best_j, aln_start, aln_end, aln_from, aln_to, 0)
// followed by the nibble-packed reverse state string (PAD_WORD fill).
//
// K4 hm_viterbi_planes replaces the same `_viterbi_kernel` in its untraced
// mode (viterbi_pallas): the DP at full profile width (band origin 0, all
// KPF lanes, MAX_REGIONS slots, unbounded D chain) writing the
// nibble-packed choice planes to device memory as [n_rows/8, B, KPF] int32
// (row g*8+r in nibble 7-r of plane g) and, per read, the f32 bits of
// (score, best_i, best_j, 0, 0, 0, 0, 0).  It does not walk the planes:
// the host or a device walk does, and viterbi_pallas drops the walk of
// its kernel too.
//
// What bounds them on the H100.  Neither bytes nor FLOPs by the count (a
// K1 read moves ~1 KB in and ~0.5 KB out at ~40 operations a cell inside
// its band; K4 adds the n_rows/8 * KPF * 4 bytes of planes a read).  The
// row recurrence is a chain of n_rows dependent steps, and a seeded 250 bp
// read allows ~260 of the narrow launch's 384 lanes in a row, so nearly
// every warp works in every row and its D runs are long enough for all
// the doubling steps.  K1's narrow launch is bound by instruction throughput:
// a few hundred instructions a lane-row (the nine doubling steps are about
// half of them) over lanes x rows, at three blocks of 56 registers a
// thread an SM.  The full-width launches (K1's wide one, K4) hold one
// 704-thread block an SM, and a block waits at each of its barriers with
// nothing else to run; there the time goes with the warps that stay in the
// row loop.
//
// Design: one thread block per read, threads over band lanes (LPT lanes
// per thread, lane l owned by thread l % blockDim, so a warp holds a slab
// of 32 consecutive lanes for each of its LPT), the row loop inside the
// block.
//   * A lane's costs are loaded once before the row loop; the next row's
//     emissions are fetched while this row computes.  The lane's own
//     previous-row M/I stay in registers; lane l-1's come from shared
//     memory, read once after the row's first barrier and kept for the
//     next row.
//   * Lane g of each warp keeps region g, works out its column interval
//     each row and turns it into a bit mask over the slab; one warp
//     reduction gives every lane its allowed and entry bits.
//   * The D chain x_j = min(a_j, x_{j-1} + c_j) is the Hillis-Steele
//     min-plus doubling of the Pallas kernel, with the same operands
//     combined in the same tree (lane l at stride s takes lane l-s), so
//     the kernel and the plain PyTorch version agree bit for bit (built
//     with -fmad=false).  Strides 1..16 run on warp shuffles with no
//     barrier: each warp carries, beside its 32 lanes, the 32 lanes before
//     them (a halo it computes itself from the published M row and the
//     neighbour warp's mask ballot), whose upper part stays valid for as
//     long as the strides need it.  Strides >= 32 go through two shared
//     buffers, read one and write the other, one barrier a step.  That
//     barrier also votes: once no lane at or past the next stride holds a
//     finite c, no later step can change any a (a + inf never wins the
//     min), so the steps stop there; a row whose D runs are shorter than
//     32 lanes takes two barriers in all.
//   * Work that can only produce +inf is not done.  A slab none of whose
//     lanes (nor the lane before them) lies in any region's columns is
//     dead: its shared-memory slots and its choice planes (all 0) are
//     written once and a warp with only dead slabs leaves the block, which
//     is most of a full-width block for a seeded read.  A slab outside the
//     hull of this row's and the previous row's intervals is quiet for the
//     row: it publishes +inf and shifts a 0 nibble into its plane word.
//   * The running best is the lexicographic minimum of (value, column,
//     row), a total order, so each thread keeps the best of its own lanes
//     over all rows and the block reduces once after the loop.
//   * Traced reads leave the row loop at their length rounded up to the
//     8-row plane: later rows only mask.  K4 runs every row, since its
//     planes past the length are output.
//   * The 4-bit choices are nibble-packed 8 rows per int32 plane; the
//     planes of a narrow band read stay in shared memory, a wide read's
//     planes go to a device-memory scratch buffer that the wrapper
//     allocates, K4's to its output, written coalesced along lanes once
//     every 8 rows.  Thread 0 then walks K1's planes and writes the state
//     string.
//
// Lanes are band-relative: lane l of read r is absolute profile position
// jb[r] + l.  Cost rows are indexed at (jb + l) mod KPF exactly like the
// TPU's per-read pltpu.roll; lanes past K are masked by the recurrences.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define MAX_REGIONS 5
#define REGION_WIDTH 8
#define PAD_NIBBLE 5
#define PAD_WORD 0x55555555
#define FULL 0xffffffffu
// a column no lane has: lo of an empty interval
#define NO_LANE 0xffff

// Shared memory by 32-bit shared-space address.  The row loop touches the
// same few slots of each lane every row; a plain array access forms a
// generic address each time, which costs more instructions than the
// access.
__device__ __forceinline__ float lds(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ unsigned ldsu(unsigned a) {
  unsigned v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void sts(unsigned a, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
}
__device__ __forceinline__ void stsu(unsigned a, unsigned v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}

struct Best {
  float v;
  int j, i;
};

// lexicographic minimum of (value, column, row)
__device__ __forceinline__ void take(Best& b, float v, int j, int i) {
  if (v < b.v || (v == b.v && (j < b.j || (j == b.j && i < b.i)))) {
    b.v = v;
    b.j = j;
    b.i = i;
  }
}

template <int LPT, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB) viterbi_kernel(
    const float* __restrict__ tc, const float* __restrict__ em,
    const float* __restrict__ scal, const int* __restrict__ codes,
    const int* __restrict__ meta, const int* __restrict__ jbv,
    int* __restrict__ comb, int* __restrict__ planes_g, int n_rows, int K,
    int KPF, int KP, int max_steps, int TPS, int n_regions, int dchain,
    int planes_in_smem, int traced) {
  extern __shared__ float smem[];
  // two (a, c) buffer pairs for the D chain's strides >= 32; the second
  // pair first carries the row's M and I to the neighbour lanes
  float* x1a = smem;
  float* x1c = x1a + KP;
  float* x0a = x1c + KP;
  float* x0c = x0a + KP;
  float* D_s = x0c + KP;
  // one D-mask word per 32 lanes
  unsigned* dm_s = reinterpret_cast<unsigned*>(D_s + KP);
  const int NG = (KP + 31) >> 5;
  __shared__ int reg_s[MAX_REGIONS * REGION_WIDTH];
  __shared__ unsigned alive_s[1];  // the warps that run the row loop

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  const int lane = tid & 31;
  const int G = n_rows / 8;
  // plane g of this read: traced, a [G, KP] block of its own (shared
  // memory or scratch); untraced, row r of the [G, B, KP] output
  const size_t pstride = traced ? (size_t)KP : (size_t)gridDim.x * KP;
  int* planes = planes_in_smem ? reinterpret_cast<int*>(dm_s + NG)
                : traced       ? planes_g + (size_t)r * G * KP
                               : planes_g + (size_t)r * KP;
  const int jb = jbv ? jbv[r] : 0;
  const int length = meta[r * 128];
  const float t_NN = scal[0], t_NB = scal[1], t_CC = scal[2],
              t_EC = scal[3], tIMK = scal[4];
  const float INF = CUDART_INF_F;
  int* out = comb + (size_t)r * (8 + TPS);
  const int* rcodes = codes + (size_t)r * n_rows;
  const int smax = min(dchain, KP);
  // rows past the read's end only mask; K4's planes there are output
  const int last =
      traced ? min(n_rows, max(8, (length + 7) & ~7)) : n_rows;

  for (int q = tid; q < MAX_REGIONS * REGION_WIDTH; q += bd)
    reg_s[q] = meta[r * 128 + 8 + q];
  for (int w = tid; w < TPS; w += bd) out[8 + w] = PAD_WORD;
  if (tid == 0) alive_s[0] = 0u;

  // per-lane constants: the lane's cost rows, and the D-chain costs of
  // its halo lane l - 32
  float cTMM[LPT], cTIM[LPT], cTDM[LPT], cTMD[LPT], cTDD[LPT], cTMI[LPT],
      cTII[LPT], cENT[LPT], cEXT[LPT], hTMD[LPT], hTDD[LPT];
  int cx[LPT];
  float Mo[LPT], Io[LPT], Ml[LPT], Il[LPT], Dl[LPT], emv[LPT], eiv[LPT];
  int pack[LPT];
  int b1 = rcodes[0];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int l = tid + k * bd;
    const bool act = l < KP;
    cx[k] = act ? (l + jb) % KPF : 0;
    cTMM[k] = act ? tc[0 * KPF + cx[k]] : INF;
    cTIM[k] = act ? tc[1 * KPF + cx[k]] : INF;
    cTDM[k] = act ? tc[2 * KPF + cx[k]] : INF;
    cTMD[k] = act ? tc[3 * KPF + cx[k]] : INF;
    cTDD[k] = act ? tc[4 * KPF + cx[k]] : INF;
    cTMI[k] = act ? tc[5 * KPF + cx[k]] : INF;
    cTII[k] = act ? tc[6 * KPF + cx[k]] : INF;
    cENT[k] = act ? tc[7 * KPF + cx[k]] : INF;
    cEXT[k] = act ? tc[8 * KPF + cx[k]] : INF;
    const int h = l - 32;
    const bool hact = h >= 0 && h < KP;
    const int hx = hact ? (h + jb) % KPF : 0;
    hTMD[k] = hact ? tc[3 * KPF + hx] : INF;
    hTDD[k] = hact ? tc[4 * KPF + hx] : INF;
    Mo[k] = Io[k] = Ml[k] = Il[k] = Dl[k] = INF;
    emv[k] = em[b1 * KPF + cx[k]];
    eiv[k] = em[(4 + b1) * KPF + cx[k]];
    pack[k] = 0;
  }
  b1 = last > 1 ? rcodes[1] : 0;
  Best bst = {INF, 1 << 30, 0};
  __syncthreads();
  // lane g of every warp keeps region g, works out its j-interval each
  // row and turns it into a bit mask over the warp's 32 lanes; the warp
  // combines the five masks with one reduction
  const int* R = reg_s + (lane < MAX_REGIONS ? lane : 0) * REGION_WIDTH;
  const bool r_used = lane < MAX_REGIONS && lane < n_regions;
  const int r_jlo = R[0], r_ilo = R[2], r_ihi = R[3], r_diag = R[5],
            r_lod = R[6], r_hid = R[7];
  const int r_jlo1 = max(r_jlo, 1), r_jhi1 = min(R[1], K);
  const bool r_ent = r_used && R[4] == 1;
  // A slab (32 lanes of one warp) is dead when neither its lanes nor the
  // lane before them lie in any region's columns: every M, I, D there is
  // +inf in every row and every choice 0, as the recurrences would find.
  // Its shared-memory slots and its planes are written once, here, and a
  // warp with dead slabs only leaves the block.  The slab of lane 0 is
  // never dead: it settles the best of a read with no finite cell.
  const bool r_cols = r_used && r_jhi1 >= r_jlo1 && r_ihi >= r_ilo;
  const int all_lo = __reduce_min_sync(FULL, r_cols ? r_jlo1 : NO_LANE);
  const int all_hi = __reduce_max_sync(FULL, r_cols ? r_jhi1 : -1);
  // run[k]: the lane exists and its slab is not dead; dinv[k]: no D state
  // at its column (D1 and DK are wing-retracted)
  bool dead[LPT], run[LPT], dinv[LPT], actp[LPT], any_alive = tid < 32;
  // sa[k]: the shared address of the lane's slot in the first buffer (x1a);
  // the other four buffers follow at KP4 bytes each, the mask words after
  unsigned sa[LPT];
  const unsigned KP4 = 4u * (unsigned)KP;
  const unsigned s_dm = (unsigned)__cvta_generic_to_shared(dm_s);
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int l = tid + k * bd;
    const int j0s = l - lane + jb - 1;
    sa[k] = (unsigned)__cvta_generic_to_shared(smem) + 4u * (unsigned)l;
    dead[k] = l - lane > 0 && !(all_hi >= j0s && all_lo <= j0s + 32);
    run[k] = l < KP && !dead[k];
    dinv[k] = l + jb <= 1 || l + jb >= K;
    // whether the slab met an allowed lane in the previous row
    actp[k] = true;
    if (dead[k] && l < KP) {
      x1a[l] = x1c[l] = x0a[l] = x0c[l] = D_s[l] = INF;
      if (lane == 0) dm_s[l >> 5] = 0u;
      for (int g = 0; g < last / 8; ++g) planes[(size_t)g * pstride + l] = 0;
    }
    any_alive = any_alive || !(dead[k] || l - lane >= KP);
  }
  if (any_alive && lane == 0) atomicOr(alive_s, 1u << (tid >> 5));
  __syncthreads();
  if (!any_alive) return;

  for (int i = 1; i <= last; ++i) {
    // the next row's emissions, in flight while this row computes
    float nemv[LPT], neiv[LPT];
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      nemv[k] = em[b1 * KPF + cx[k]];
      neiv[k] = em[(4 + b1) * KPF + cx[k]];
    }
    const int b2 = i + 1 < last ? rcodes[i + 1] : 0;
    const float col0 =
        __fadd_rn(i == 1 ? 0.0f : __fmul_rn(t_NN, (float)(i - 1)), t_NB);
    // this lane's region in this row (masks_for_row): columns lo..hi,
    // none when lo > hi; the hull of all regions' columns
    int lo = NO_LANE, hi = -1;
    if (r_used && i >= r_ilo && i <= r_ihi) {
      const int ci = i - r_ilo;
      lo = r_diag != 0 ? max(r_jlo1, r_jlo + ci - r_hid) : r_jlo1;
      hi = r_diag != 0 ? min(r_jhi1, r_jlo + ci - r_lod) : r_jhi1;
      if (hi < lo) {
        lo = NO_LANE;
        hi = -1;
      }
    }
    const int hull_lo = __reduce_min_sync(FULL, lo);
    const int hull_hi = __reduce_max_sync(FULL, hi);

    float Mn[LPT], In[LPT], av[LPT], cv[LPT], fresh[LPT], ha[LPT], hc[LPT];
    bool dmask[LPT], quiet[LPT];
    int ch[LPT];
    // ---- phase 1: M and I from the previous row ----
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int l = tid + k * bd;
      const int jabs = l + jb;
      // A slab is quiet in this row when neither its 32 lanes nor the lane
      // before them can be allowed in this row or were in the row before
      // (by the hull of the regions' intervals): all its M, I, D are
      // +inf and all its choices 0, as the recurrences would find.  The
      // first row is never quiet (it settles the best of a read with no
      // finite cell), nor is the slab of column 0.
      const int j0s = jabs - lane - 1;
      const bool act = hull_hi >= j0s && hull_lo <= j0s + 32;
      quiet[k] = dead[k] || (i > 1 && !act && !actp[k] && j0s >= 0);
      actp[k] = act;
      if (quiet[k]) {
        if (run[k]) {
          sts(sa[k], INF);
          sts(sa[k] + KP4, INF);
          if (lane == 0) stsu(s_dm + 4u * (l >> 5), 0u);
        }
        Mn[k] = In[k] = av[k] = cv[k] = fresh[k] = INF;
        dmask[k] = false;
        ch[k] = 0;
        continue;
      }
      // bits t_lo..t_hi of this lane's region over the slab's lanes
      const int t_lo = max(lo - (jabs - lane), 0);
      const int t_hi = min(hi - (jabs - lane), 31);
      const unsigned bits =
          t_lo <= t_hi ? (FULL >> (31 - max(t_hi, 0))) & (FULL << min(t_lo, 31))
                       : 0u;
      const unsigned amask = __reduce_or_sync(FULL, bits);
      const unsigned emask = __reduce_or_sync(FULL, r_ent ? bits : 0u);
      const bool allowed = ((amask >> lane) & 1u) && l < KP;
      const bool entry_ok = (emask >> lane) & 1u;
      const float optB = entry_ok ? __fadd_rn(col0, cENT[k]) : INF;
      const float optM = __fadd_rn(Ml[k], cTMM[k]);
      const float optI = __fadd_rn(Il[k], cTIM[k]);
      const float optD = __fadd_rn(Dl[k], cTDM[k]);
      const float mn = fminf(fminf(optB, optM), fminf(optI, optD));
      float m = __fadd_rn(emv[k], mn);
      int cM = optB <= mn ? 0 : (optM <= mn ? 1 : (optI <= mn ? 2 : 3));
      if (jabs == 1) cM = optB <= optI ? 0 : 2;
      if (!allowed) m = INF;
      if (jabs == 0) m = col0;
      const float iM = __fadd_rn(Mo[k], cTMI[k]);
      const float iI = __fadd_rn(Io[k], cTII[k]);
      float in = __fadd_rn(eiv[k], fminf(iM, iI));
      int cI = iM > iI ? 1 : 0;
      if (!allowed) in = INF;
      if (jabs == 0) in = col0;
      // j==0 I choice: this row's B column vs I(i-1, lane 0)
      if (jabs == 0 && l == 0)
        cI = __fadd_rn(m, cTMI[k]) > __fadd_rn(Io[k], cTII[k]) ? 1 : 0;
      Mn[k] = m;
      In[k] = in;
      ch[k] = cM | (cI << 2);
      dmask[k] = allowed && !dinv[k];
      if (l < KP) {
        sts(sa[k], m);
        sts(sa[k] + KP4, in);
      }
      // the warp's D mask, for the halo of the warp that follows
      const unsigned bal = __ballot_sync(FULL, dmask[k]);
      if (lane == 0 && l < KP) stsu(s_dm + 4u * (l >> 5), bal);
    }
    __syncthreads();
    // ---- phase 2: D chain x_j = min(a_j, x_{j-1} + c_j) ----
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      if (quiet[k]) continue;
      const int l = tid + k * bd;
      const bool nb = l > 0 && l < KP;
      // this row's lane l-1, kept for the next row too
      Ml[k] = nb ? lds(sa[k] - 4u) : INF;
      Il[k] = nb ? lds(sa[k] + KP4 - 4u) : INF;
      fresh[k] = __fadd_rn(Ml[k], cTMD[k]);
      av[k] = dmask[k] ? fresh[k] : INF;
      cv[k] = dmask[k] ? cTDD[k] : INF;
      // halo lane h = l - 32: before lane 0, a = inf and c = 0
      const int h = l - 32;
      ha[k] = INF;
      hc[k] = h < 0 ? 0.0f : INF;
      if (h >= 0 && h < KP &&
          ((ldsu(s_dm + 4u * (h >> 5)) >> lane) & 1u)) {
        const float hM = h > 0 ? lds(sa[k] - 132u) : INF;
        ha[k] = __fadd_rn(hM, hTMD[k]);
        hc[k] = hTDD[k];
      }
    }
#pragma unroll
    for (int s = 1; s < 32; s *= 2) {
      if (s >= smax) break;
      const int src = (lane - s) & 31;
      const bool own = lane >= s;
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        if (quiet[k]) continue;
        const float xo = __shfl_up_sync(FULL, av[k], s);
        const float xh = __shfl_sync(FULL, ha[k], src);
        const float co = __shfl_up_sync(FULL, cv[k], s);
        const float ch_ = __shfl_sync(FULL, hc[k], src);
        // halo position p takes p - s; positions below the strides' sum
        // hold junk that no own lane reaches
        const float nha = fminf(__fadd_rn(xh, hc[k]), ha[k]);
        const float nhc = __fadd_rn(ch_, hc[k]);
        av[k] = fminf(__fadd_rn(own ? xo : xh, cv[k]), av[k]);
        cv[k] = __fadd_rn(own ? co : ch_, cv[k]);
        ha[k] = nha;
        hc[k] = nhc;
      }
    }
    // strides >= 32 through shared memory: read one (a, c) buffer pair at
    // byte offset rb, write the other; each barrier publishes D and
    // votes on going on
    int s = 32;
    unsigned rb = 2u * KP4;
    for (;;) {
      int want = 0;
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        if (run[k]) {
          sts(sa[k] + 4u * KP4, dinv[k] ? INF : av[k]);
          if (s < smax) {
            sts(sa[k] + rb, av[k]);
            sts(sa[k] + rb + KP4, cv[k]);
            want |= (tid + k * bd >= s && cv[k] < INF) ? 1 : 0;
          }
        }
      }
      if (!__syncthreads_or(want)) break;
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        if (run[k] && !quiet[k]) {
          const bool far = tid + k * bd >= s;
          const unsigned from = sa[k] + rb - 4u * (unsigned)s;
          const float a_sh = far ? lds(from) : INF;
          const float c_sh = far ? lds(from + KP4) : 0.0f;
          av[k] = fminf(__fadd_rn(a_sh, cv[k]), av[k]);
          cv[k] = __fadd_rn(c_sh, cv[k]);
        }
      }
      s *= 2;
      rb = 2u * KP4 - rb;
    }
    // ---- phase 3: D choice, S row, running best ----
    const bool live = i <= length;
    const float c_loops =
        i < length ? __fmul_rn(t_CC, (float)(length - i)) : 0.0f;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int l = tid + k * bd;
      const int jabs = l + jb;
      if (!quiet[k]) {
        Dl[k] = (l > 0 && l < KP) ? lds(sa[k] + 4u * KP4 - 4u) : INF;
        const int cD = fresh[k] > __fadd_rn(Dl[k], cTDD[k]) ? 1 : 0;
        ch[k] |= cD << 3;
        if (l < KP) {
          float sm = __fadd_rn(__fadd_rn(__fadd_rn(Mn[k], cEXT[k]), t_EC),
                               c_loops);
          if (!(jabs <= K && live)) sm = INF;
          if (sm <= bst.v) take(bst, sm, jabs, i);
          if (jabs == K) {
            // the I(i, K) exit, as column K + 1
            float s_i = __fadd_rn(
                __fadd_rn(__fadd_rn(In[k], tIMK), t_EC), c_loops);
            if (!live) s_i = INF;
            if (s_i <= bst.v) take(bst, s_i, K + 1, i);
          }
        }
        Mo[k] = Mn[k];
        Io[k] = In[k];
      }
      if (run[k]) {
        pack[k] = (pack[k] << 4) | ch[k];
        if ((i & 7) == 0) {
          planes[(size_t)((i >> 3) - 1) * pstride + l] = pack[k];
          pack[k] = 0;
        }
      }
      emv[k] = nemv[k];
      eiv[k] = neiv[k];
    }
    b1 = b2;
  }

  // block reduction of the per-thread bests, once; the partials reuse the
  // chain buffers, which the last row's closing barrier has retired
  Best* red_b = reinterpret_cast<Best*>(smem);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_down_sync(FULL, bst.v, o);
    const int j = __shfl_down_sync(FULL, bst.j, o);
    const int i2 = __shfl_down_sync(FULL, bst.i, o);
    take(bst, v, j, i2);
  }
  if (lane == 0) red_b[tid >> 5] = bst;
  __syncthreads();
  if (tid != 0) {
    if (!traced && tid >= 3 && tid < 8) out[tid] = 0;
    return;
  }
  for (int w = 1; w < (bd + 31) >> 5; ++w)
    if ((alive_s[0] >> w) & 1u) take(bst, red_b[w].v, red_b[w].j, red_b[w].i);
  const float best = bst.v;
  const int best_i = bst.i, best_j = bst.j;
  out[0] = __float_as_int(best);
  out[1] = __float_as_int((float)best_i);
  out[2] = __float_as_int((float)best_j);
  if (!traced) return;

  // ---- traceback (reference buildViterbiTrace, BandedHMMP7.cpp:943-1006)
  int s = best_j <= K ? 1 : 2;
  const int j0 = min(best_j, K);
  int j = j0 - jb;  // band-relative walk
  int i = best_i;
  uint32_t word = PAD_WORD;
  int t = 0;
  for (; t < max_steps; ++t) {
    if (!(i >= 1 && j >= 0)) break;
    const int sh_t = 4 * (7 - (t & 7));
    word = (word & ~(15u << sh_t)) | ((uint32_t)s << sh_t);
    const int g = (i - 1) >> 3;
    const int jc = min(j, KP - 1);
    const uint32_t w = (uint32_t)planes[(size_t)g * pstride + jc];
    const int c = (int)((w >> (4 * (7 - ((i - 1) & 7)))) & 15u);
    const int cm = c & 3, cI = (c >> 2) & 1, cD = (c >> 3) & 1;
    int s_n = s, i_n = i, j_n = j;
    if (s == 1) {
      s_n = cm;
      i_n = i - 1;
      j_n = j - 1;
    } else if (s == 2) {
      s_n = (j + jb > 0) ? (cI == 0 ? 1 : 2) : (cI == 0 ? 0 : 2);
      i_n = i - 1;
    } else if (s == 3) {
      s_n = cD == 0 ? 1 : 3;
      j_n = j - 1;
    }
    if ((t & 7) == 7) {
      out[8 + (t >> 3)] = (int)word;
      word = PAD_WORD;
    }
    if (s == 0) {
      ++t;
      break;
    }
    s = s_n;
    i = i_n;
    j = j_n;
  }
  if ((t & 7) != 0) out[8 + ((t - 1) >> 3)] = (int)word;
  out[3] = __float_as_int((float)(j + jb + 1));
  out[4] = __float_as_int((float)j0);
  out[5] = __float_as_int((float)(i + 1));
  out[6] = __float_as_int((float)best_i);
  out[7] = 0;
}

template <int LPT, int MAXT, int MINB>
static cudaError_t launch(const float* tc, const float* em, const float* scal,
                          const int* codes, const int* meta, const int* jb,
                          int* comb, int* planes_g, int B, int n_rows, int K,
                          int KPF, int KP, int max_steps, int TPS,
                          int n_regions, int dchain, int threads,
                          int planes_in_smem, int traced,
                          cudaStream_t stream) {
  size_t smem = (size_t)5 * KP * sizeof(float) +
                (size_t)((KP + 31) / 32) * sizeof(unsigned);
  if (planes_in_smem) smem += (size_t)(n_rows / 8) * KP * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      viterbi_kernel<LPT, MAXT, MINB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  viterbi_kernel<LPT, MAXT, MINB><<<B, threads, smem, stream>>>(
      tc, em, scal, codes, meta, jb, comb, planes_g, n_rows, K, KPF, KP,
      max_steps, TPS, n_regions, dchain, planes_in_smem, traced);
  return cudaGetLastError();
}

#define VITERBI_ARGS                                                       \
  tc, em, scal, codes, meta, jb, comb, planes_g, B, n_rows, K, KPF, KP,    \
      max_steps, TPS, n_regions, dchain, threads, planes_in_smem, traced, st

static cudaError_t dispatch(const float* tc, const float* em,
                            const float* scal, const int* codes,
                            const int* meta, const int* jb, int* comb,
                            int* planes_g, int B, int n_rows, int K, int KPF,
                            int KP, int max_steps, int TPS, int n_regions,
                            int dchain, int lpt, int threads,
                            int planes_in_smem, int traced,
                            cudaStream_t st) {
  // the partials of the closing reduction need 32 * 12 bytes of the chain
  // buffers
  if (threads % 32 != 0 || lpt * threads < KP || KP < 32)
    return cudaErrorInvalidValue;
  // columns travel in half-words
  if (K + KP >= NO_LANE) return cudaErrorInvalidValue;
  // the register budget follows the block size and the blocks an SM should
  // hold: 3 of the narrow launch (56 registers a thread), on the H100 the
  // fastest of 2, 3 and 4
  if (lpt == 1 && threads <= 384) return launch<1, 384, 3>(VITERBI_ARGS);
  if (lpt == 1 && threads <= 512) return launch<1, 512, 1>(VITERBI_ARGS);
  if (lpt == 2 && threads <= 512) return launch<2, 512, 1>(VITERBI_ARGS);
  if (lpt == 2 && threads <= 768) return launch<2, 768, 1>(VITERBI_ARGS);
  if (lpt == 4 && threads <= 512) return launch<4, 512, 1>(VITERBI_ARGS);
  if (lpt == 8 && threads <= 1024) return launch<8, 1024, 1>(VITERBI_ARGS);
  return cudaErrorInvalidValue;
}

extern "C" int hm_viterbi_traced(const float* tc, const float* em,
                                 const float* scal, const int* codes,
                                 const int* meta, const int* jb, int* comb,
                                 int* planes_g, int B, int n_rows, int K,
                                 int KPF, int KP, int max_steps, int TPS,
                                 int n_regions, int dchain, int lpt,
                                 int threads, int planes_in_smem,
                                 void* stream) {
  if (B == 0) return 0;
  if (n_rows % 8 != 0 || n_rows < 8) return (int)cudaErrorInvalidValue;
  return (int)dispatch(tc, em, scal, codes, meta, jb, comb, planes_g, B,
                       n_rows, K, KPF, KP, max_steps, TPS, n_regions, dchain,
                       lpt, threads, planes_in_smem, 1,
                       (cudaStream_t)stream);
}

// K4: sb [B, 8] int32 (f32 bits of score, best_i, best_j, then zeros),
// packed [n_rows/8, B, KPF] int32
extern "C" int hm_viterbi_planes(const float* tc, const float* em,
                                 const float* scal, const int* codes,
                                 const int* meta, int* sb, int* packed,
                                 int B, int n_rows, int K, int KPF, int lpt,
                                 int threads, void* stream) {
  if (B == 0) return 0;
  if (n_rows % 8 != 0 || n_rows < 8) return (int)cudaErrorInvalidValue;
  return (int)dispatch(tc, em, scal, codes, meta, nullptr, sb, packed, B,
                       n_rows, K, KPF, KPF, 0, 0, MAX_REGIONS, 1 << 30, lpt,
                       threads, 0, 0, (cudaStream_t)stream);
}
