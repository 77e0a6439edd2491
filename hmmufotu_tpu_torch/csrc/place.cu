// K2, K3 and K5: the SEP placement estimate, the joint 3-branch
// branch-length optimization, and the single-branch fixed point on its own.
//
// K2 hm_est replaces hmmufotu_tpu/phylo/pallas_place.py `_est_kernel`
// (est_pallas): per candidate lane, the spectral P(t) = U exp(lam t) U^-1
// convolutions of the up/down messages at (wur0, wvr0) with max-shift
// scaling, the first-index argmax mismatch fraction -> wnr0, and the
// closed-form estimate loglik over the masked sites.
//
// K3 hm_sep replaces `_sep_kernel` (sep_optimize_pallas): the joint
// 3-branch Felsenstein fixed point with discrete-Gamma rate mixing — two
// inner single-branch fixed points inside the outer loop, per-lane
// convergence (BRANCH_EPS, MAX_ITER) — then the root-message loglik and
// the loop trip counts.  A lane that is not live keeps its zeros.
//
// K5 hm_fp replaces hmmufotu_tpu/phylo/placement.py `_fp_kernel`
// (_fixed_point_pallas): the single-branch Felsenstein fixed point
// p <- sum_w eB_w p / (eA_w (1 - p) + eB_w p) / n on site factors that the
// caller pre-scaled, to convergence per lane.  It serves the placer whose
// outer 3-branch loop and rate-mixed convolutions stay tensor ops.
//
// What bounds them on the H100: K2 is bound by transcendentals (per site
// ~12 expf + 8 logf and ~200 flops over 48 B of messages, far above the
// card's bytes-per-flop line).  K3 is bound by instruction throughput on
// its live lanes: a branch set-up costs a site 34 accurate expf and 38 logf
// (the log-domain rate mixing of the reference, kept operation for
// operation), twice an outer trip, against ~20 instructions a site for a
// fixed-point step; about 2% of the lanes are live on the bundled
// reference set, far more on a tree of near-identical leaves.  K5 is
// bound by bytes on paper (a live lane's two W-site rows read once, 2 flops
// a byte per trip over ~10-30 trips); in fact by the latency of each
// lane's dependent chain of divide, warp sum and two log1pf a trip, and by
// the few lanes that are live.
//
// Design.  K2: one block per candidate lane, threads over the W sites,
// block reductions for the counts and sums; the rate-free convolutions are
// computed per site in registers and never stored.
// K3: a grid of as many blocks as the card holds at once; each block takes
// the next live lane off a device-side list (an atomic counter, so long
// and short lanes balance and a dead lane costs nothing; its output row
// stays the zero the caller wrote).  Threads over the sites, each thread
// owning the same sites from load to loglik, so the lane's messages, its
// pi-dots of U and N (computed once a lane) and its fixed-point factors sit
// in shared memory with no barrier.  What does not depend on the site is
// taken out of the site loop: the 4x4 P(t) of each (branch, rate) is
// built once a set-up, one entry a thread, into shared memory, and
// exp(msg - scale) of a message once a site, not once a rate.  The
// operands and the order of every site's operations are those of the
// plain version; only the order of the sums over sites differs.  A block
// sum costs one barrier (two partial rows, taken in turn).  The code of a
// site is kept small: the two branch set-ups of an outer trip are one
// function that is not inlined, and the loops over the rates and the
// states are not unrolled.  Unrolled and inlined the kernel was 7,888
// instructions and ran a third slower: the warps of a block stand at
// different places of the site loop and waited on instruction fetches.
// K5 takes one warp per lane: the TPU
// kernel steps 128 lanes together until all are done, but a done lane is
// frozen, so a lane's result depends on that lane alone and each warp
// stops at its own convergence; the lane's eA/eB rows are read from device
// memory once into shared memory, each thread keeping the sites it sums,
// and a skipped lane's warp returns p_init without reading them.
// Accurate expf/logf/log1pf (no fast
// math) and no FMA contraction (-fmad=false), as in the plain versions.

#include <cuda_runtime.h>
#include <math_constants.h>

#define MAX_ITER 100
#define BRANCH_EPS 1e-5f
#define THREADS 128

struct Model {
  float U[16], Ui[16], lam[4], logpi[4], rates[8];
};

__device__ __forceinline__ float guard(float m) {
  return (m > -CUDART_INF_F && m < CUDART_INF_F) ? m : 0.0f;
}

__device__ __forceinline__ float max4(const float* x) {
  return fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
}

// log(P(t) @ exp(msg)) at one site; e[j] = exp(lam_j * t)
__device__ __forceinline__ void conv_one(const Model& md, const float* msg,
                                         const float* e, float* out) {
  const float scale = guard(max4(msg));
  float em[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) em[l] = expf(msg[l] - scale);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float acc = 0.0f;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      float p = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float term = (md.U[k * 4 + j] * md.Ui[j * 4 + l]) * e[j];
        p = j == 0 ? term : p + term;
      }
      p = fmaxf(p, 0.0f);
      const float v = p * em[l];
      acc = l == 0 ? v : acc + v;
    }
    out[k] = logf(acc) + scale;
  }
}

// log(pi . exp(msg)) at one site
__device__ __forceinline__ float dot_vec(const float* logpi,
                                         const float* msg) {
  const float scale = guard(max4(msg));
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v = expf(logpi[k] + msg[k] - scale);
    s = k == 0 ? v : s + v;
  }
  return logf(s) + scale;
}

__device__ __forceinline__ int argmax4(const float* x) {
  float best = x[0];
  int idx = 0;
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (x[k] > best) idx = k;
    best = fmaxf(best, x[k]);
  }
  return idx;
}

// block-wide sum, result broadcast to every thread
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read by the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

__device__ void load_model(const float* ms, Model& md) {
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    md.U[q] = ms[q];
    md.Ui[q] = ms[16 + q];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    md.lam[q] = ms[32 + q];
    md.logpi[q] = ms[36 + q];
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) md.rates[q] = ms[40 + q];
}

__global__ void est_kernel(const float* __restrict__ Up,
                           const float* __restrict__ Vp,
                           const float* __restrict__ Np,
                           const float* __restrict__ maskp,
                           const float* __restrict__ scal,
                           const float* __restrict__ ms,
                           float* __restrict__ out, int M, int Wp) {
  extern __shared__ float R0_s[];  // [4][Wp]
  __shared__ float red[32];
  const int m = blockIdx.x;
  Model md;
  load_model(ms, md);
  const float wur0 = scal[2 * m], wvr0 = scal[2 * m + 1];
  float eU[4], eV[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    eU[j] = expf(md.lam[j] * wur0);
    eV[j] = expf(md.lam[j] * wvr0);
  }
  const size_t plane = (size_t)M * Wp, row = (size_t)m * Wp;
  float cnt = 0.0f, mis = 0.0f;
  for (int w = threadIdx.x; w < Wp; w += blockDim.x) {
    float u[4], v[4], n[4], a[4], b[4], r0[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      u[k] = Up[k * plane + row + w];
      v[k] = Vp[k * plane + row + w];
      n[k] = Np[k * plane + row + w];
    }
    conv_one(md, u, eU, a);
    conv_one(md, v, eV, b);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      r0[k] = a[k] + b[k];
      R0_s[k * Wp + w] = r0[k];
    }
    const bool msk = maskp[row + w] > 0.5f;
    cnt += msk ? 1.0f : 0.0f;
    mis += (msk && argmax4(r0) != argmax4(n)) ? 1.0f : 0.0f;
  }
  const float nsites = fmaxf(block_sum(cnt, red), 1.0f);
  const float wnr0 = block_sum(mis, red) / nsites;
  float eN[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) eN[j] = expf(md.lam[j] * wnr0);
  float acc = 0.0f;
  for (int w = threadIdx.x; w < Wp; w += blockDim.x) {
    float n[4], c[4], x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) n[k] = Np[k * plane + row + w];
    conv_one(md, n, eN, c);
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = R0_s[k * Wp + w] + c[k];
    const float col = dot_vec(md.logpi, x);
    acc += maskp[row + w] > 0.5f ? col : 0.0f;
  }
  const float est = block_sum(acc, red);
  if (threadIdx.x == 0) {
    out[2 * m] = est;
    out[2 * m + 1] = wnr0;
  }
}

// ---- K3 ----------------------------------------------------------------

// sum over the block, the same value in every thread; one barrier: the
// warps' partials go to red[par], and the next call takes the other row
__device__ __forceinline__ float lane_sum(float v, float (*red)[32],
                                          int& par) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[par][threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[par][0];
  for (int w = 1; w < THREADS / 32; ++w) s += red[par][w];
  par ^= 1;
  return s;
}

// P(t_p * rate_r) = max(U diag(exp(lam t)) U^-1, 0) for NP branch lengths
// and NR rates into P_s[(p * NR + r) * 16 + k * 4 + l], one entry a thread
template <int NR, int NP>
__device__ __forceinline__ void fill_p(const float* __restrict__ ms,
                                       const float* t, float* P_s) {
  for (int q = threadIdx.x; q < NP * NR * 16; q += blockDim.x) {
    const int l = q & 3, k = (q >> 2) & 3, g = q >> 4;
    const float tt = t[g / NR] * ms[40 + g % NR];
    float p = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float term =
          (ms[k * 4 + j] * ms[16 + j * 4 + l]) * expf(ms[32 + j] * tt);
      p = j == 0 ? term : p + term;
    }
    P_s[q] = fmaxf(p, 0.0f);
  }
  __syncthreads();
}

// exp(msg - scale) of one site's message, scale = its guarded maximum
__device__ __forceinline__ float lin4(const float* msg, float* e) {
  const float scale = guard(max4(msg));
#pragma unroll
  for (int l = 0; l < 4; ++l) e[l] = expf(msg[l] - scale);
  return scale;
}

// log(P @ e) + scale at one site, P a 4x4 of P_s
__device__ __forceinline__ void conv_p(const float* P, const float* e,
                                       float scale, float* out) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 row = *reinterpret_cast<const float4*>(P + k * 4);
    float acc = row.x * e[0];
    acc = acc + row.y * e[1];
    acc = acc + row.z * e[2];
    acc = acc + row.w * e[3];
    out[k] = logf(acc) + scale;
  }
}

// rate-mixed summed convolution at one site of NP messages given as
// (e, scale); P_s as fill_p leaves it.  The loops over the rates and over
// the states stay loops (the rate sums go through local memory): unrolled,
// a site's code outgrows the instruction cache and the warps of a block,
// each at its own place in it, wait on fetches.
template <int NR, int NP>
__device__ __forceinline__ void conv_mix(const float* P_s, const float* e,
                                         const float* scale, float* out) {
  float s[NR][4];
#pragma unroll 1
  for (int r = 0; r < NR; ++r) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float c[4];
      conv_p(P_s + (p * NR + r) * 16, e + p * 4, scale[p], c);
#pragma unroll
      for (int k = 0; k < 4; ++k) s[r][k] = p == 0 ? c[k] : s[r][k] + c[k];
    }
  }
  if (NR == 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = s[0][k];
    return;
  }
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    float mx = s[0][k];
#pragma unroll
    for (int r = 1; r < NR; ++r) mx = fmaxf(mx, s[r][k]);
    const float scl = guard(mx);
    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float v = expf(s[r][k] - scl);
      acc = r == 0 ? v : acc + v;
    }
    out[k] = logf(acc / (float)NR) + scl;
  }
}

// fixed point of one branch given the per-site factors eA/eB (reference
// optimizeBranchLength(u,v), cpp:749-798); a thread sums the sites it
// wrote
__device__ float fixed_point(const float* eA, const float* eB, float n,
                             float w_cur, float max_len, int Wp,
                             float (*red)[32], int& par, int* trips) {
  float p = 1.0f - expf(-w_cur);
  const float sat = (float)(1.0 - 1e-7);
  int it = 0;
  for (; it < MAX_ITER;) {
    float part = 0.0f;
    for (int w = threadIdx.x; w < Wp; w += blockDim.x) {
      const float num = eB[w] * p;
      const float den = eA[w] * (1.0f - p) + num;
      part += den > 0.0f ? num / den : 0.0f;
    }
    const float pn = lane_sum(part, red, par) / n;
    ++it;
    const bool bad = !(pn >= 0.0f && pn <= 1.0f);
    const float diff = fabsf(log1pf(-pn) - log1pf(-p));
    const bool conv = diff < BRANCH_EPS ||
                      !(diff > -CUDART_INF_F && diff < CUDART_INF_F) ||
                      pn >= sat;
    if (!bad) p = pn;
    if (conv || bad) break;
  }
  *trips += it;
  return fminf(-log1pf(-p), max_len);
}

// the per-lane arrays of K3 in shared memory, [4][Wp] messages and [Wp]
// site vectors
struct SepLane {
  float *U, *V, *N, *mask, *eA, *eB, *dU, *dN;
};

// Fills eA/eB for the branch whose far side is X (dX its pi-dot), near
// side the rate-mixed convolution of the two (message, length) pairs;
// returns the informative-site count n.  One copy of the code for both
// branches, to keep the kernel inside the instruction cache.
template <int NR>
__device__ __noinline__ float sep_setup(const float* __restrict__ ms,
                                        const SepLane& ln, float* P_s,
                                        float (*red)[32], int& par,
                                        const float* P0, float t0,
                                        const float* P1, float t1,
                                        const float* X, const float* dX,
                                        int Wp) {
  const float logpi[4] = {ms[36], ms[37], ms[38], ms[39]};
  const float tt[2] = {t0, t1};
  fill_p<NR, 2>(ms, tt, P_s);
  float cnt = 0.0f;
  for (int w = threadIdx.x; w < Wp; w += blockDim.x) {
    float a[4], b[4], e[8], scale[2], r[4], rx[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a[k] = P0[k * Wp + w];
      b[k] = P1[k * Wp + w];
    }
    scale[0] = lin4(a, e);
    scale[1] = lin4(b, e + 4);
    conv_mix<NR, 2>(P_s, e, scale, r);
#pragma unroll
    for (int k = 0; k < 4; ++k) rx[k] = r[k] + X[k * Wp + w];
    const float logA = dot_vec(logpi, rx);
    const float logB = dot_vec(logpi, r) + dX[w];
    const bool ok = ln.mask[w] > 0.5f && !(isnan(logA) || isnan(logB));
    const float scl = fmaxf(logA, logB);
    ln.eA[w] = ok ? expf(logA - scl) : 0.0f;
    ln.eB[w] = ok ? expf(logB - scl) : 0.0f;
    cnt += ok ? 1.0f : 0.0f;
  }
  // its barrier also retires this call's reads of P_s
  return fmaxf(lane_sum(cnt, red, par), 1.0f);
}

// lanes [n_live] lists the live lanes; ctrl[0] = n_live, ctrl[1] = the next list entry to take (0 at launch).
// THREADS threads a lane, 4 blocks an SM (128 registers a thread): on the
// H100 128 threads were the fastest of 32, 64, 128 and 256, and they sum a
// lane's sites in the order that keeps the inner trip counts closest to the
// plain version's.
template <int NR>
__global__ void __launch_bounds__(THREADS, 4)
sep_kernel(const float* __restrict__ Up, const float* __restrict__ Vp,
           const float* __restrict__ Np, const float* __restrict__ maskp,
           const float* __restrict__ scal, const float* __restrict__ ms,
           const int* __restrict__ lanes, int* ctrl, float* __restrict__ out,
           int M, int Wp) {
  extern __shared__ float sm[];
  // every per-site array is touched only by the thread that owns the
  // site (w = tid mod blockDim), so none of them needs a barrier
  SepLane ln;
  ln.U = sm;
  ln.V = ln.U + 4 * Wp;
  ln.N = ln.V + 4 * Wp;
  ln.mask = ln.N + 4 * Wp;
  ln.eA = ln.mask + Wp;
  ln.eB = ln.eA + Wp;
  ln.dU = ln.eB + Wp;  // log(pi . exp(U)), log(pi . exp(N))
  ln.dN = ln.dU + Wp;
  __shared__ __align__(16) float P_s[3 * NR * 16];
  __shared__ float red[2][32];
  __shared__ int cur_s;
  const int n_live = ctrl[0];
  const float logpi[4] = {ms[36], ms[37], ms[38], ms[39]};
  const size_t plane = (size_t)M * Wp;
  int par = 0;

  for (;;) {
    __syncthreads();  // the lane before is done with cur_s, P_s, red
    if (threadIdx.x == 0) cur_s = atomicAdd(ctrl + 1, 1);
    __syncthreads();
    if (cur_s >= n_live) return;
    const int m = lanes[cur_s];
    const size_t row = (size_t)m * Wp;
    for (int w = threadIdx.x; w < Wp; w += blockDim.x) {
      float u[4], x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        u[k] = ln.U[k * Wp + w] = Up[k * plane + row + w];
        ln.V[k * Wp + w] = Vp[k * plane + row + w];
        x[k] = ln.N[k * Wp + w] = Np[k * plane + row + w];
      }
      ln.mask[w] = maskp[row + w];
      ln.dU[w] = dot_vec(logpi, u);
      ln.dN[w] = dot_vec(logpi, x);
    }
    const float w0 = scal[3 * m];
    float wur = scal[3 * m + 1], wnr = scal[3 * m + 2];
    float wvr = w0 - wur;
    int o_trips = 0, i_trips = 0;

    for (int it = 0; it < MAX_ITER; ++it) {
      ++o_trips;
      float n = sep_setup<NR>(ms, ln, P_s, red, par, ln.U, wur, ln.V, wvr,
                               ln.N, ln.dN, Wp);
      const float wnr_n = fixed_point(ln.eA, ln.eB, n, wnr, 1.0f, Wp, red, par,
                                      &i_trips);
      n = sep_setup<NR>(ms, ln, P_s, red, par, ln.V, wvr, ln.N, wnr_n, ln.U,
                         ln.dU, Wp);
      const float wur_n = fixed_point(ln.eA, ln.eB, n, wur, w0, Wp, red, par,
                                      &i_trips);
      const float wvr_n = w0 - wur_n;
      const bool convd =
          fabsf(wur_n - wur) < BRANCH_EPS && fabsf(wnr_n - wnr) < BRANCH_EPS;
      const bool bad = !(wur_n >= 0.0f && wur_n <= w0);
      wur = wur_n;
      wvr = wvr_n;
      wnr = wnr_n;
      if (convd || bad) break;
    }

    // root-message loglik over the masked sites
    const float tt[3] = {wur, wvr, wnr};
    fill_p<NR, 3>(ms, tt, P_s);
    float acc = 0.0f;
    for (int w = threadIdx.x; w < Wp; w += blockDim.x) {
      float a[4], e[12], scale[3], r[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k] = ln.U[k * Wp + w];
      scale[0] = lin4(a, e);
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k] = ln.V[k * Wp + w];
      scale[1] = lin4(a, e + 4);
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k] = ln.N[k * Wp + w];
      scale[2] = lin4(a, e + 8);
      conv_mix<NR, 3>(P_s, e, scale, r);
      const float col = dot_vec(logpi, r);
      acc += ln.mask[w] > 0.5f ? col : 0.0f;
    }
    const float ll = lane_sum(acc, red, par);
    if (threadIdx.x == 0) {
      float* o = out + (size_t)m * 8;
      o[0] = wur;
      o[1] = wvr;
      o[2] = wnr;
      o[3] = ll;
      o[4] = (float)o_trips;
      o[5] = (float)i_trips;
    }
  }
}

// K5: one warp per lane, FP_WARPS lanes a block; scal [M, 4] = (n, p_init,
// skip, 0); shared memory [FP_WARPS][2][W]
#define FP_WARPS 8

__global__ void fp_kernel(const float* __restrict__ eA,
                          const float* __restrict__ eB,
                          const float* __restrict__ scal,
                          float* __restrict__ out, int M, int W) {
  extern __shared__ float fp_s[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * FP_WARPS + warp;
  if (m >= M) return;
  const float n = scal[4 * m];
  float p = scal[4 * m + 1];
  if (scal[4 * m + 2] > 0.5f) {  // lane starts done
    if (lane == 0) out[m] = p;
    return;
  }
  // thread t keeps sites t, t+32, ...: it alone reads what it wrote
  float* a = fp_s + (size_t)warp * 2 * W;
  float* b = a + W;
  const size_t row = (size_t)m * W;
  for (int w = lane; w < W; w += 32) {
    a[w] = eA[row + w];
    b[w] = eB[row + w];
  }
  const float sat = (float)(1.0 - 1e-7);
  for (int it = 0; it < MAX_ITER; ++it) {
    float part = 0.0f;
    for (int w = lane; w < W; w += 32) {
      const float num = b[w] * p;
      const float den = a[w] * (1.0f - p) + num;
      part += den > 0.0f ? num / den : 0.0f;
    }
    // butterfly sum: every thread of the warp holds the same total
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    const float pn = part / n;
    const bool bad = !(pn >= 0.0f && pn <= 1.0f);
    const float diff = fabsf(log1pf(-pn) - log1pf(-p));
    const bool conv = diff < BRANCH_EPS ||
                      !(diff > -CUDART_INF_F && diff < CUDART_INF_F) ||
                      pn >= sat;
    if (!bad) p = pn;
    if (conv || bad) break;
  }
  if (lane == 0) out[m] = p;
}

extern "C" int hm_fp(const float* eA, const float* eB, const float* scal,
                     float* out, int M, int W, void* stream) {
  if (M == 0) return 0;
  const size_t smem = (size_t)FP_WARPS * 2 * W * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      fp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (M + FP_WARPS - 1) / FP_WARPS;
  fp_kernel<<<blocks, FP_WARPS * 32, smem, (cudaStream_t)stream>>>(
      eA, eB, scal, out, M, W);
  return (int)cudaGetLastError();
}

extern "C" int hm_est(const float* Up, const float* Vp, const float* Np,
                      const float* maskp, const float* scal, const float* ms,
                      float* out, int M, int Wp, void* stream) {
  if (M == 0) return 0;
  const size_t smem = (size_t)4 * Wp * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      est_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  est_kernel<<<M, THREADS, smem, (cudaStream_t)stream>>>(
      Up, Vp, Np, maskp, scal, ms, out, M, Wp);
  return (int)cudaGetLastError();
}

template <int NR>
static int launch_sep(const float* Up, const float* Vp, const float* Np,
                      const float* maskp, const float* scal, const float* ms,
                      const int* lanes, int* ctrl, float* out, int M, int Wp,
                      cudaStream_t st) {
  const size_t smem = (size_t)17 * Wp * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      sep_kernel<NR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  // as many blocks as the card holds at once; each takes live lanes off
  // the list until it is empty
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, sep_kernel<NR>, THREADS, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const int blocks = min(M, sms * per_sm);
  sep_kernel<NR><<<blocks, THREADS, smem, st>>>(Up, Vp, Np, maskp, scal, ms,
                                                lanes, ctrl, out, M, Wp);
  return (int)cudaGetLastError();
}

// scal [M, 3] = (w0, wur0, wnr0); lanes [>= n_live] int32 the live lanes,
// ctrl [2] int32 = (n_live, 0); out [M, 8] zeroed by the caller, a live
// lane's row filled here
extern "C" int hm_sep(const float* Up, const float* Vp, const float* Np,
                      const float* maskp, const float* scal, const float* ms,
                      const int* lanes, int* ctrl, float* out, int M, int Wp,
                      int n_rates, void* stream) {
  if (M == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_rates == 1)
    return launch_sep<1>(Up, Vp, Np, maskp, scal, ms, lanes, ctrl, out, M,
                         Wp, st);
  if (n_rates == 4)
    return launch_sep<4>(Up, Vp, Np, maskp, scal, ms, lanes, ctrl, out, M,
                         Wp, st);
  return (int)cudaErrorInvalidValue;
}
