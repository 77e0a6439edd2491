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
// What bounds them on the H100.  K1: neither bytes nor FLOPs.  A read
// moves ~1 KB in and ~0.5 KB out; its DP does ~100 flops per cell.  The
// row recurrence is a chain of n_rows dependent steps, each a handful of
// block-wide barriers (the D chain's log-depth doubling scan and the row
// argmin), so the kernel is latency-bound on __syncthreads and on the
// serial single-thread traceback walk.  K4: by the bound, bytes (the
// n_rows/8 * KPF * 4 bytes of planes a read, 369 MB for 2,048 reads of 256
// rows at 1,408 lanes, outweigh the ~40 operations of each cell inside
// the band); in fact the same barrier chain, with log2(KPF) doubling
// steps a row instead of K1's bounded 6-10.  Its plane words are written
// coalesced along lanes, once every 8 rows.
//
// Design: one thread block per read, threads over band lanes (LPT lanes
// per thread, lane l owned by thread l % blockDim), the row loop inside
// the block.  The previous row's M/I/D live in shared memory because the
// recurrences read lane j-1.  The D chain is the same Hillis-Steele
// min-plus doubling as the Pallas kernel, bounded by the same host
// `dchain`, so the kernel and the plain PyTorch version agree bit for bit
// (compiled with -fmad=false: no multiply-add is contracted).  The 4-bit
// choices are nibble-packed 8 rows per int32 plane; the planes of a
// narrow band read stay in shared memory, a wide read's planes go to a
// device-memory scratch buffer that the wrapper allocates.  Thread 0
// then walks the planes and writes the state string.
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

struct Pair {
  float v;
  int j;
};

__device__ __forceinline__ Pair pmin(Pair a, Pair b) {
  // value first, then smaller lane (column-major tie-break)
  if (b.v < a.v || (b.v == a.v && b.j < a.j)) return b;
  return a;
}

template <int LPT>
__global__ void viterbi_kernel(
    const float* __restrict__ tc, const float* __restrict__ em,
    const float* __restrict__ scal, const int* __restrict__ codes,
    const int* __restrict__ meta, const int* __restrict__ jbv,
    int* __restrict__ comb, int* __restrict__ planes_g, int n_rows, int K,
    int KPF, int KP, int max_steps, int TPS, int n_regions, int dchain,
    int planes_in_smem, int traced) {
  extern __shared__ float smem[];
  float* M_s = smem;
  float* I_s = M_s + KP;
  float* D_s = I_s + KP;
  float* a_s = D_s + KP;
  float* c_s = a_s + KP;
  __shared__ Pair red_p[32];
  __shared__ float red_k[32];
  __shared__ int reg_s[MAX_REGIONS * REGION_WIDTH];
  __shared__ float best_s;
  __shared__ int best_i_s, best_j_s;

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  const int G = n_rows / 8;
  // plane g of this read: traced, a [G, KP] block of its own (shared
  // memory or scratch); untraced, row r of the [G, B, KP] output
  const size_t pstride = traced ? (size_t)KP : (size_t)gridDim.x * KP;
  int* planes = planes_in_smem ? reinterpret_cast<int*>(c_s + KP)
                : traced       ? planes_g + (size_t)r * G * KP
                               : planes_g + (size_t)r * KP;
  const int jb = jbv ? jbv[r] : 0;
  const int length = meta[r * 128];
  const float t_NN = scal[0], t_NB = scal[1], t_CC = scal[2],
              t_EC = scal[3], tIMK = scal[4];
  const float INF = CUDART_INF_F;
  int* out = comb + (size_t)r * (8 + TPS);

  for (int q = tid; q < MAX_REGIONS * REGION_WIDTH; q += bd)
    reg_s[q] = meta[r * 128 + 8 + q];
  for (int l = tid; l < KP; l += bd) {
    M_s[l] = INF;
    I_s[l] = INF;
    D_s[l] = INF;
  }
  for (int w = tid; w < TPS; w += bd) out[8 + w] = PAD_WORD;
  if (tid == 0) {
    best_s = INF;
    best_i_s = 0;
    best_j_s = 1 << 30;
  }
  __syncthreads();

  int pack[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) pack[k] = 0;

  for (int i = 1; i <= n_rows; ++i) {
    const int b = codes[(size_t)r * n_rows + i - 1];
    const float col0 =
        __fadd_rn(i == 1 ? 0.0f : __fmul_rn(t_NN, (float)(i - 1)), t_NB);
    // per-region j-interval of this row (masks_for_row)
    int lo_r[MAX_REGIONS], hi_r[MAX_REGIONS];
    bool ent_r[MAX_REGIONS];
#pragma unroll
    for (int g = 0; g < MAX_REGIONS; ++g) {
      lo_r[g] = 1 << 30;
      hi_r[g] = 0;
      ent_r[g] = false;
      if (g < n_regions) {
        const int* R = reg_s + g * REGION_WIDTH;
        const int j_lo = R[0], j_hi = R[1], i_lo = R[2], i_hi = R[3];
        const int ent = R[4], diag = R[5], lo_d = R[6], hi_d = R[7];
        const int j_lo1 = max(j_lo, 1), j_hi1 = min(j_hi, K);
        const int ci = i - i_lo;
        int lo = diag != 0 ? max(j_lo1, j_lo + ci - hi_d) : j_lo1;
        const int hi = diag != 0 ? min(j_hi1, j_lo + ci - lo_d) : j_hi1;
        if (!(i >= i_lo && i <= i_hi)) lo = 1 << 30;
        lo_r[g] = lo;
        hi_r[g] = hi;
        ent_r[g] = ent == 1;
      }
    }

    float Mn[LPT], In[LPT], TMD_r[LPT], TDD_r[LPT];
    bool allowed_r[LPT];
    int ch[LPT];
    float ci0 = 0.0f;
    // ---- phase 1: M and I from the previous row ----
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int l = tid + k * bd;
      Mn[k] = INF;
      In[k] = INF;
      ch[k] = 0;
      allowed_r[k] = false;
      TMD_r[k] = INF;
      TDD_r[k] = INF;
      if (l < KP) {
        const int jabs = l + jb;
        const int cx = jabs % KPF;
        bool allowed = false, entry_ok = false;
#pragma unroll
        for (int g = 0; g < MAX_REGIONS; ++g) {
          const bool cov = jabs >= lo_r[g] && jabs <= hi_r[g];
          allowed = allowed || cov;
          entry_ok = entry_ok || (cov && ent_r[g]);
        }
        const float TMM_sh = tc[0 * KPF + cx], TIM_sh = tc[1 * KPF + cx],
                    TDM_sh = tc[2 * KPF + cx];
        TMD_r[k] = tc[3 * KPF + cx];
        TDD_r[k] = tc[4 * KPF + cx];
        const float TMI = tc[5 * KPF + cx], TII = tc[6 * KPF + cx],
                    entry_c = tc[7 * KPF + cx];
        const float emv = em[b * KPF + cx], eiv = em[(4 + b) * KPF + cx];
        const float Mp1 = l > 0 ? M_s[l - 1] : INF;
        const float Ip1 = l > 0 ? I_s[l - 1] : INF;
        const float Dp1 = l > 0 ? D_s[l - 1] : INF;
        const float optB = entry_ok ? __fadd_rn(col0, entry_c) : INF;
        const float optM = __fadd_rn(Mp1, TMM_sh);
        const float optI = __fadd_rn(Ip1, TIM_sh);
        const float optD = __fadd_rn(Dp1, TDM_sh);
        const float mn = fminf(fminf(optB, optM), fminf(optI, optD));
        float m = __fadd_rn(emv, mn);
        int cM = optB <= mn ? 0 : (optM <= mn ? 1 : (optI <= mn ? 2 : 3));
        if (jabs == 1) cM = optB <= optI ? 0 : 2;
        if (!allowed) m = INF;
        if (jabs == 0) m = col0;
        const float iM = __fadd_rn(M_s[l], TMI);
        const float iI = __fadd_rn(I_s[l], TII);
        float in = __fadd_rn(eiv, fminf(iM, iI));
        int cI = iM > iI ? 1 : 0;
        if (!allowed) in = INF;
        if (jabs == 0) in = col0;
        if (l == 0) ci0 = TMI;  // lane-0 TMI, used below
        Mn[k] = m;
        In[k] = in;
        ch[k] = cM | (cI << 2);
        allowed_r[k] = allowed;
      }
    }
    // j==0 I choice: this row's B column vs I(i-1, lane 0)
    if (tid == 0 && jb == 0) {
      const float TII0 = tc[6 * KPF + 0];
      const int c = __fadd_rn(Mn[0], ci0) > __fadd_rn(I_s[0], TII0) ? 1 : 0;
      ch[0] = (ch[0] & ~4) | (c << 2);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int l = tid + k * bd;
      if (l < KP) {
        M_s[l] = Mn[k];
        I_s[l] = In[k];
      }
    }
    __syncthreads();
    // ---- phase 2: D chain x_j = min(a_j, x_{j-1} + c_j) ----
    float av[LPT], cv[LPT], fresh[LPT];
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int l = tid + k * bd;
      av[k] = INF;
      cv[k] = INF;
      fresh[k] = INF;
      if (l < KP) {
        const int jabs = l + jb;
        const bool d_invalid = jabs <= 1 || jabs >= K;
        const float Mn_sh = l > 0 ? M_s[l - 1] : INF;
        fresh[k] = __fadd_rn(Mn_sh, TMD_r[k]);
        const bool dmask = !d_invalid && allowed_r[k];
        av[k] = dmask ? fresh[k] : INF;
        cv[k] = dmask ? TDD_r[k] : INF;
        a_s[l] = av[k];
        c_s[l] = cv[k];
      }
    }
    __syncthreads();
    const int smax = min(dchain, KP);
    for (int s = 1; s < smax; s *= 2) {
      float na[LPT], nc[LPT];
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int l = tid + k * bd;
        na[k] = av[k];
        nc[k] = cv[k];
        if (l < KP) {
          const float a_sh = l >= s ? a_s[l - s] : INF;
          const float c_sh = l >= s ? c_s[l - s] : 0.0f;
          na[k] = fminf(__fadd_rn(a_sh, cv[k]), av[k]);
          nc[k] = __fadd_rn(c_sh, cv[k]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int l = tid + k * bd;
        av[k] = na[k];
        cv[k] = nc[k];
        if (l < KP) {
          a_s[l] = na[k];
          c_s[l] = nc[k];
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int l = tid + k * bd;
      if (l < KP) {
        const int jabs = l + jb;
        const bool d_invalid = jabs <= 1 || jabs >= K;
        D_s[l] = d_invalid ? INF : av[k];
      }
    }
    __syncthreads();
    // ---- phase 3: D choice, S row, running best ----
    const bool live = i <= length;
    const float c_loops =
        i < length ? __fmul_rn(t_CC, (float)(length - i)) : 0.0f;
    Pair pm = {INF, 1 << 30};
    float ink = INF;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int l = tid + k * bd;
      if (l < KP) {
        const int jabs = l + jb;
        const int cx = jabs % KPF;
        const float Dp1 = l > 0 ? D_s[l - 1] : INF;
        const int cD = fresh[k] > __fadd_rn(Dp1, TDD_r[k]) ? 1 : 0;
        ch[k] |= cD << 3;
        const float exit_c = tc[8 * KPF + cx];
        float sm = __fadd_rn(__fadd_rn(__fadd_rn(Mn[k], exit_c), t_EC),
                             c_loops);
        if (!(jabs <= K && live)) sm = INF;
        pm = pmin(pm, Pair{sm, jabs});
        if (jabs == K) ink = In[k];
        pack[k] = (pack[k] << 4) | ch[k];
        if ((i & 7) == 0) {
          planes[(size_t)((i >> 3) - 1) * pstride + l] = pack[k];
          pack[k] = 0;
        }
      }
    }
    // block reduction of (row min, first lane) and of the lane-K I value
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      Pair other;
      other.v = __shfl_down_sync(0xffffffffu, pm.v, o);
      other.j = __shfl_down_sync(0xffffffffu, pm.j, o);
      pm = pmin(pm, other);
      ink = fminf(ink, __shfl_down_sync(0xffffffffu, ink, o));
    }
    const int warp = tid >> 5, lane = tid & 31, nwarp = (bd + 31) >> 5;
    if (lane == 0) {
      red_p[warp] = pm;
      red_k[warp] = ink;
    }
    __syncthreads();
    if (tid == 0) {
      Pair rp = red_p[0];
      float rk = red_k[0];
      for (int w = 1; w < nwarp; ++w) {
        rp = pmin(rp, red_p[w]);
        rk = fminf(rk, red_k[w]);
      }
      float s_i = __fadd_rn(__fadd_rn(__fadd_rn(rk, tIMK), t_EC), c_loops);
      if (!live) s_i = INF;
      const float row_min = fminf(rp.v, s_i);
      const int row_j = rp.v <= s_i ? rp.j : K + 1;
      if (row_min < best_s || (row_min == best_s && row_j < best_j_s)) {
        best_s = row_min;
        best_i_s = i;
        best_j_s = row_j;
      }
    }
    // red_* and the shared row state are rewritten only after the next
    // row's first barrier, which thread 0 reaches after this update
  }
  __syncthreads();

  if (!traced) {
    if (tid == 0) {
      out[0] = __float_as_int(best_s);
      out[1] = __float_as_int((float)best_i_s);
      out[2] = __float_as_int((float)best_j_s);
    }
    if (tid >= 3 && tid < 8) out[tid] = 0;
    return;
  }
  // ---- traceback (reference buildViterbiTrace, BandedHMMP7.cpp:943-1006)
  if (tid == 0) {
    const float best = best_s;
    const int best_i = best_i_s, best_j = best_j_s;
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
    out[0] = __float_as_int(best);
    out[1] = __float_as_int((float)best_i);
    out[2] = __float_as_int((float)best_j);
    out[3] = __float_as_int((float)(j + jb + 1));
    out[4] = __float_as_int((float)j0);
    out[5] = __float_as_int((float)(i + 1));
    out[6] = __float_as_int((float)best_i);
    out[7] = 0;
  }
}

template <int LPT>
static cudaError_t launch(const float* tc, const float* em, const float* scal,
                          const int* codes, const int* meta, const int* jb,
                          int* comb, int* planes_g, int B, int n_rows, int K,
                          int KPF, int KP, int max_steps, int TPS,
                          int n_regions, int dchain, int threads,
                          int planes_in_smem, int traced,
                          cudaStream_t stream) {
  size_t smem = (size_t)5 * KP * sizeof(float);
  if (planes_in_smem) smem += (size_t)(n_rows / 8) * KP * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      viterbi_kernel<LPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  viterbi_kernel<LPT><<<B, threads, smem, stream>>>(
      tc, em, scal, codes, meta, jb, comb, planes_g, n_rows, K, KPF, KP,
      max_steps, TPS, n_regions, dchain, planes_in_smem, traced);
  return cudaGetLastError();
}

static cudaError_t dispatch(const float* tc, const float* em,
                            const float* scal, const int* codes,
                            const int* meta, const int* jb, int* comb,
                            int* planes_g, int B, int n_rows, int K, int KPF,
                            int KP, int max_steps, int TPS, int n_regions,
                            int dchain, int lpt, int threads,
                            int planes_in_smem, int traced,
                            cudaStream_t st) {
  switch (lpt) {
    case 1:
      return launch<1>(tc, em, scal, codes, meta, jb, comb, planes_g, B,
                       n_rows, K, KPF, KP, max_steps, TPS, n_regions, dchain,
                       threads, planes_in_smem, traced, st);
    case 2:
      return launch<2>(tc, em, scal, codes, meta, jb, comb, planes_g, B,
                       n_rows, K, KPF, KP, max_steps, TPS, n_regions, dchain,
                       threads, planes_in_smem, traced, st);
    case 4:
      return launch<4>(tc, em, scal, codes, meta, jb, comb, planes_g, B,
                       n_rows, K, KPF, KP, max_steps, TPS, n_regions, dchain,
                       threads, planes_in_smem, traced, st);
    case 8:
      return launch<8>(tc, em, scal, codes, meta, jb, comb, planes_g, B,
                       n_rows, K, KPF, KP, max_steps, TPS, n_regions, dchain,
                       threads, planes_in_smem, traced, st);
    default:
      return cudaErrorInvalidValue;
  }
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
  if (n_rows % 8 != 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch(tc, em, scal, codes, meta, nullptr, sb, packed, B,
                       n_rows, K, KPF, KPF, 0, 0, MAX_REGIONS, 1 << 30, lpt,
                       threads, 0, 0, (cudaStream_t)stream);
}
