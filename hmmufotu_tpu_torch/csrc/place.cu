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
// What bounds them on the H100.  K2 is bound by instruction issue: at each
// masked site of each lane it computes ~25 accurate transcendentals on 32
// B of messages, ~540 SASS instructions a lane-site on the bundled set
// (pass 1 415, pass 2 111 at an observed base, 240 elsewhere), against a
// bytes bound of the masked U/V read once that is about a third of its
// time.  K3 is bound by instruction throughput on
// its live lanes: a branch set-up costs a site 34 accurate expf and 38 logf
// (the log-domain rate mixing of the reference, kept operation for
// operation), twice an outer trip, against ~20 instructions a site for a
// fixed-point step; about 2% of the lanes are live on the bundled
// reference set, far more on a tree of near-identical leaves.  K5 is
// bound by bytes on paper (a live lane's two W-site rows read once, 2 flops
// a byte per trip over ~10-30 trips); in fact by the latency of its
// slowest lane's dependent chain (a block sum, a divide by n and one
// log1pf a trip), ~0.45 us a trip on the H100.
//
// Design.  K2: one block per read, its C candidate lanes taken in turn by
// EST_WARPS warps (C = 50 over 5 warps: 10 lanes each, no warp idles; a
// block of 5 warps keeps 4 blocks on an SM, the shared memory's limit).
// What depends on the read alone is done once a read into shared memory:
// exp(N - scale), the scale and argmax4(N) of each masked site (N and the
// mask are per read, [4, B, Wp] and [B, Wp]), and two lists of the
// masked sites in site order: those where exp(N - scale) is one-hot (an
// observed base) and the others.  A warp builds its lane's P(wur0) and
// P(wvr0) once, one entry a thread, and then walks the read's masked
// sites off the lists, so any mask costs no divergence: U/V are loaded
// there and nowhere else (neighbouring threads on neighbouring sites; a
// 16-byte load a thread would make a warp step over 128 sites and leave a
// third of a 256-site run's slots idle), R0 goes to the warp's own
// [4][Wp] slice of shared memory,
// and the mismatch count and the loglik are warp butterflies with no
// block barrier.  In pass 2 the convolution of N at a one-hot site is
// P(wnr0)[k][base] exactly, so its log comes from a 16-entry table the
// lane builds once: the same bits for ~130 instructions less a site.  A
// site's values are those of the plain version operation for operation;
// only the sums over sites are taken in another order (wnr0, a count, is
// exact).
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
// K5: in one C call, a small kernel lists the lanes not skipped (and
// writes p_init for the others), then a grid sized to the card takes the
// listed lanes, one 128-thread block a lane (a block's first lane by its
// index, the next ones off an atomic counter), so a skipped lane costs
// nothing.  The TPU kernel steps 128 lanes together until all are done,
// but a done lane is frozen, so a lane's result depends on that lane
// alone and each block stops at its own convergence.  A lane's sites are
// read once into registers, S a thread (4 at W = 512).  A trip's chain is
// short: a thread divides S sites, independent of each other, the block
// sum costs one barrier, and log1pf(-p) is carried from one trip to the
// next.  The sum follows a fixed halving tree over the site
// positions, which the plain version repeats (cuda_fixed_point.tree_sum),
// so kernel and plain version agree bit for bit and stop on the same
// trip.  A one-warp design that compacted the nonzero sites into
// registers was tried and dropped: its chain was twice as long and its
// order of summation made a lane stop one step apart from the plain
// version's.
// Accurate expf/logf/log1pf (no fast math) and no FMA contraction
// (-fmad=false), as in the plain versions.

#include <cuda_runtime.h>
#include <math_constants.h>

#define MAX_ITER 100
#define BRANCH_EPS 1e-5f
#define THREADS 128

__device__ __forceinline__ float guard(float m) {
  return (m > -CUDART_INF_F && m < CUDART_INF_F) ? m : 0.0f;
}

__device__ __forceinline__ float max4(const float* x) {
  return fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
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

// ---- K2 ----------------------------------------------------------------

// warps a block: C = 50 lanes over 5 warps is 10 each with none idle, and
// a block of 5 warps keeps 4 blocks on an SM at Wp = 512 (shared memory)
#define EST_WARPS 5

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dynamic shared memory of a K2 block of nw warps: per read exp(N - scale)
// [4][Wp], its scale [Wp], per 32-site chunk the counts of the two site
// lists [2][Wp / 32], the lists [Wp] (int16) and each site's code [Wp]
// (int8); per warp the lane's R0 [4][Wp]
static size_t est_smem(int nw, int Wp) {
  const size_t nch = (Wp + 31) / 32;
  return (size_t)(5 + 4 * nw) * Wp * sizeof(float) + 2 * nch * sizeof(int) +
         (size_t)Wp * (sizeof(short) + 1);
}

// one block per read b: lanes m = b * C + j, j < C; Nr [4][B][Wp] and
// maskr [B][Wp] per read, Up/Vp [4][B * C][Wp] per lane; scal [B * C][2] =
// (wur0, wvr0); out [B * C][2] = (est, wnr0)
__global__ void __launch_bounds__(EST_WARPS * 32, 4)
est_kernel(const float* __restrict__ Up, const float* __restrict__ Vp,
           const float* __restrict__ Nr, const float* __restrict__ maskr,
           const float* __restrict__ scal, const float* __restrict__ ms,
           float* __restrict__ out, int B, int C, int Wp) {
  extern __shared__ __align__(16) float est_s[];
  // per warp P(wur0), P(wvr0), P(wnr0) and log P(wnr0)
  __shared__ __align__(16) float P_s[EST_WARPS][64];
  __shared__ int n_one_s, n_gen_s;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  const int b = blockIdx.x, nch = (Wp + 31) / 32;
  float* en = est_s;                        // [4][Wp] exp(N - scale)
  float* nsc = en + 4 * Wp;                 // [Wp] scale of N
  float* R = nsc + Wp + (size_t)warp * 4 * Wp;  // this warp's R0 [4][Wp]
  int* chunk = reinterpret_cast<int*>(nsc + Wp + 4 * nw * Wp);  // [2][nch]
  short* list = reinterpret_cast<short*>(chunk + 2 * nch);      // [Wp]
  // argmax4(N) at a masked site, + 4 where exp(N - scale) is one-hot
  // (an observed base); -1 at an unmasked site
  signed char* nb = reinterpret_cast<signed char*>(list + Wp);

  // ---- the read: once a block
  const size_t nplane = (size_t)B * Wp, nrow = (size_t)b * Wp;
  for (int w = threadIdx.x; w < Wp; w += blockDim.x) {
    signed char code = -1;
    if (maskr[nrow + w] > 0.5f) {
      float n[4], e[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) n[k] = Nr[k * nplane + nrow + w];
      nsc[w] = lin4(n, e);
      int ones = 0, zeros = 0;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        en[l * Wp + w] = e[l];
        ones += e[l] == 1.0f;
        zeros += e[l] == 0.0f;
      }
      code = (signed char)(argmax4(n) + (ones == 1 && zeros == 3 ? 4 : 0));
    }
    nb[w] = code;
  }
  __syncthreads();
  // the masked sites in site order, the one-hot ones from the front of
  // list, the others from its back: counts per 32-site chunk, their
  // prefix, then the places
  for (int q = warp; q < nch; q += nw) {
    const int w = 32 * q + lane;
    const int code = w < Wp ? nb[w] : -1;
    const unsigned one = __ballot_sync(0xffffffffu, code >= 4);
    const unsigned gen = __ballot_sync(0xffffffffu, code >= 0 && code < 4);
    if (lane == 0) {
      chunk[q] = __popc(one);
      chunk[nch + q] = __popc(gen);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int s1 = 0, s2 = 0;
    for (int q = 0; q < nch; ++q) {
      const int c1 = chunk[q], c2 = chunk[nch + q];
      chunk[q] = s1;
      chunk[nch + q] = s2;
      s1 += c1;
      s2 += c2;
    }
    n_one_s = s1;
    n_gen_s = s2;
  }
  __syncthreads();
  for (int q = warp; q < nch; q += nw) {
    const int w = 32 * q + lane;
    const int code = w < Wp ? nb[w] : -1;
    const unsigned lt = (1u << lane) - 1u;
    const unsigned one = __ballot_sync(0xffffffffu, code >= 4);
    const unsigned gen = __ballot_sync(0xffffffffu, code >= 0 && code < 4);
    if (code >= 4) list[chunk[q] + __popc(one & lt)] = (short)w;
    if (code >= 0 && code < 4)
      list[Wp - 1 - (chunk[nch + q] + __popc(gen & lt))] = (short)w;
  }
  __syncthreads();
  const int n_one = n_one_s, n_gen = n_gen_s;
  const float nsites = fmaxf((float)(n_one + n_gen), 1.0f);
  const float logpi[4] = {ms[36], ms[37], ms[38], ms[39]};
  float* P = P_s[warp];

  // ---- the read's lanes, one warp each in turn
  const size_t plane = (size_t)B * C * Wp;
  for (int j = warp; j < C; j += nw) {
    const int m = b * C + j;
    const size_t row = (size_t)m * Wp;
    __syncwarp();  // the lane before is done with P
    {
      // P(wur0) into P[0:16], P(wvr0) into P[16:32], one entry a thread
      const int q = lane & 15, k = q >> 2, l = q & 3;
      const float t = scal[2 * m + (lane >> 4)];
      float p = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float term =
            (ms[k * 4 + jj] * ms[16 + jj * 4 + l]) * expf(ms[32 + jj] * t);
        p = jj == 0 ? term : p + term;
      }
      P[lane] = fmaxf(p, 0.0f);
    }
    __syncwarp();

    // pass 1: R0 = log(P(wur0) exp(U)) + log(P(wvr0) exp(V)) at the masked
    // sites, and its argmax mismatches against N's
    const float* up[4];
    const float* vp[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      up[k] = Up + k * plane + row;
      vp[k] = Vp + k * plane + row;
    }
    float mis = 0.0f;
    for (int i = lane; i < n_one + n_gen; i += 32) {
      const int w = i < n_one ? list[i] : list[Wp - 1 - (i - n_one)];
      const int best = nb[w] & 3;
      float u[4], v[4], eu[4], ev[4], a[4], c[4], r0[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        u[k] = up[k][w];
        v[k] = vp[k][w];
      }
      const float su = lin4(u, eu), sv = lin4(v, ev);
      conv_p(P, eu, su, a);
      conv_p(P + 16, ev, sv, c);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        r0[k] = a[k] + c[k];
        R[k * Wp + w] = r0[k];
      }
      mis += argmax4(r0) != best ? 1.0f : 0.0f;
    }
    const float wnr0 = warp_sum(mis) / nsites;

    // P(wnr0) into P[32:48], its log into P[48:64]
    if (lane < 16) {
      const int k = lane >> 2, l = lane & 3;
      float p = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float term =
            (ms[k * 4 + jj] * ms[16 + jj * 4 + l]) * expf(ms[32 + jj] * wnr0);
        p = jj == 0 ? term : p + term;
      }
      p = fmaxf(p, 0.0f);
      P[32 + lane] = p;
      P[48 + lane] = logf(p);
    }
    __syncwarp();

    // pass 2: the estimate's loglik over the masked sites, taken from the
    // two lists (R0 of a site another thread wrote: the __syncwarp above
    // orders it).  At a one-hot site exp(N - scale) is 1 at the base and
    // 0 elsewhere, so conv_p's sum is P[k][base] exactly and its value
    // logf(P[k][base]) + scale: the same bits from the lane's table.
    float acc = 0.0f;
    for (int i = lane; i < n_one; i += 32) {
      const int w = list[i], base = nb[w] & 3;
      const float sc = nsc[w];
      float x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        x[k] = R[k * Wp + w] + (P[48 + k * 4 + base] + sc);
      acc += dot_vec(logpi, x);
    }
    for (int i = lane; i < n_gen; i += 32) {
      const int w = list[Wp - 1 - i];
      float e[4], c[4], x[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) e[l] = en[l * Wp + w];
      conv_p(P + 32, e, nsc[w], c);
#pragma unroll
      for (int k = 0; k < 4; ++k) x[k] = R[k * Wp + w] + c[k];
      acc += dot_vec(logpi, x);
    }
    const float est = warp_sum(acc);
    if (lane == 0) {
      out[2 * m] = est;
      out[2 * m + 1] = wnr0;
    }
  }
}

// ---- K5 ----------------------------------------------------------------

// K5's lane list, in the same stream before fp_kernel: a skipped lane's
// output is its p_init; a live lane is appended to lanes[] (in no fixed
// order: a lane's result depends on that lane alone), ctrl[0] counting
// them from 0
__global__ void fp_list_kernel(const unsigned char* __restrict__ skip,
                               const float* __restrict__ p_init,
                               int* __restrict__ lanes, int* ctrl,
                               float* __restrict__ out, int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = m < M && !skip[m];
  if (m < M && !live) out[m] = p_init[m];
  const unsigned msk = __ballot_sync(0xffffffffu, live);
  int base = 0;
  if (lane == 0 && msk) base = atomicAdd(ctrl, __popc(msk));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (live) lanes[base + __popc(msk & ((1u << lane) - 1u))] = m;
}

// blocks of a persistent grid: as many as the card holds at once, fewer
// for a small launch
static int grid_blocks(const void* kernel, int threads, size_t smem,
                       int want, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  *blocks = min(want, sms * per_sm);
  return 0;
}

// sum of eB p / (eA (1 - p) + eB p) over a lane's sites, 0 where the
// denominator is not positive (the plain version's operations at a site),
// added up by the halving tree of cuda_fixed_point.tree_sum: thread t
// holds sites t + THREADS j, j < S, so the tree's levels above THREADS
// values pair the thread's own slots j and j + h, and the last seven pair
// threads, two through shared memory (red, one barrier; the buffer
// alternates between calls) and five by a butterfly
template <int S>
__device__ __forceinline__ float fp_sum(const float* a, const float* b,
                                        float p, float (*red)[THREADS],
                                        int& par) {
  float x[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float num = b[j] * p;
    const float den = a[j] * (1.0f - p) + num;
    x[j] = den > 0.0f ? num / den : 0.0f;
  }
#pragma unroll
  for (int h = S / 2; h >= 1; h /= 2)
#pragma unroll
    for (int j = 0; j < h; ++j) x[j] = x[j] + x[j + h];
  const int lane = threadIdx.x & 31;
  red[par][threadIdx.x] = x[0];
  __syncthreads();
  float y = (red[par][lane] + red[par][lane + 64]) +
            (red[par][lane + 32] + red[par][lane + 96]);
  par ^= 1;
  return warp_sum(y);
}

// lanes [n_live] the live lanes, ctrl[0] = n_live, ctrl[1] = 0 at launch;
// out gets p of each live lane.  One lane a block at a time: a block's
// first lane by its index, the next ones off the counter.  W <= THREADS S.
template <int S>
__global__ void __launch_bounds__(THREADS)
fp_kernel(const float* __restrict__ eA, const float* __restrict__ eB,
          const float* __restrict__ nn, const float* __restrict__ p_init,
          const int* __restrict__ lanes, int* ctrl, float* __restrict__ out,
          int W) {
  __shared__ float red[2][THREADS];
  __shared__ int cur_s;
  const int tid = threadIdx.x;
  const int n_live = ctrl[0];
  const float sat = (float)(1.0 - 1e-7);
  int par = 0;
  for (int cur = blockIdx.x; cur < n_live;) {
    const int m = lanes[cur];
    const size_t row = (size_t)m * W;
    // the lane's sites, read once into registers (0 past W)
    float a[S], b[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int w = tid + THREADS * j;
      a[j] = w < W ? eA[row + w] : 0.0f;
      b[j] = w < W ? eB[row + w] : 0.0f;
    }
    const float n = nn[m];
    float p = p_init[m];
    float lp = log1pf(-p);
    for (int it = 0; it < MAX_ITER; ++it) {
      const float y = fp_sum<S>(a, b, p, red, par);
      const float pn = y / n;
      const bool bad = !(pn >= 0.0f && pn <= 1.0f);
      const float lpn = log1pf(-pn);
      const float diff = fabsf(lpn - lp);
      const bool conv = diff < BRANCH_EPS ||
                        !(diff > -CUDART_INF_F && diff < CUDART_INF_F) ||
                        pn >= sat;
      if (!bad) {
        p = pn;
        lp = lpn;
      }
      if (conv || bad) break;
    }
    if (tid == 0) {
      out[m] = p;
      cur_s = atomicAdd(ctrl + 1, 1) + gridDim.x;
    }
    __syncthreads();
    cur = cur_s;
    __syncthreads();  // cur_s read before the next lane's thread 0 writes it
  }
}

template <int S>
static int launch_fp(const float* eA, const float* eB, const float* n,
                     const float* p_init, int* lanes, int* ctrl, float* out,
                     int M, int W, cudaStream_t st) {
  int blocks = 0;
  const int rc = grid_blocks((const void*)fp_kernel<S>, THREADS, 0, M,
                             &blocks);
  if (rc) return rc;
  fp_kernel<S><<<blocks, THREADS, 0, st>>>(eA, eB, n, p_init, lanes, ctrl,
                                           out, W);
  return (int)cudaGetLastError();
}

// eA/eB [M][W], W <= 8192 (64 sites a thread), n/p_init [M] f32, skip
// [M] bool; lanes [M] int32 and ctrl [2] int32 scratch; out [M] gets
// p_init for a skipped lane and the fixed point for a live one.  Two
// launches: the lane list, then the lanes.
extern "C" int hm_fp(const float* eA, const float* eB, const float* n,
                     const float* p_init, const unsigned char* skip,
                     int* lanes, int* ctrl, float* out, int M, int W,
                     void* stream) {
  if (M == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(ctrl, 0, 2 * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  fp_list_kernel<<<(M + 255) / 256, 256, 0, st>>>(skip, p_init, lanes, ctrl,
                                                  out, M);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  switch ((W + THREADS - 1) / THREADS) {
    case 0:
    case 1: return launch_fp<1>(eA, eB, n, p_init, lanes, ctrl, out, M, W, st);
    case 2: return launch_fp<2>(eA, eB, n, p_init, lanes, ctrl, out, M, W, st);
    case 3:
    case 4: return launch_fp<4>(eA, eB, n, p_init, lanes, ctrl, out, M, W, st);
    default:
      if (W <= 8 * THREADS)
        return launch_fp<8>(eA, eB, n, p_init, lanes, ctrl, out, M, W, st);
      if (W <= 16 * THREADS)
        return launch_fp<16>(eA, eB, n, p_init, lanes, ctrl, out, M, W, st);
      if (W <= 32 * THREADS)
        return launch_fp<32>(eA, eB, n, p_init, lanes, ctrl, out, M, W, st);
      if (W <= 64 * THREADS)
        return launch_fp<64>(eA, eB, n, p_init, lanes, ctrl, out, M, W, st);
      return (int)cudaErrorInvalidValue;
  }
}

// Up/Vp [4][B * C][Wp] per lane, Nr [4][B][Wp] and maskr [B][Wp] per read,
// scal [B * C][2] = (wur0, wvr0); out [B * C][2] = (est, wnr0).  Fewer
// warps a block where a wide window leaves no room for EST_WARPS R0
// slices; none fitting is an error.
extern "C" int hm_est(const float* Up, const float* Vp, const float* Nr,
                      const float* maskr, const float* scal, const float* ms,
                      float* out, int B, int C, int Wp, void* stream) {
  if (B == 0 || C == 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return (int)e;
  cudaFuncAttributes fa;
  if ((e = cudaFuncGetAttributes(&fa, est_kernel)) != cudaSuccess)
    return (int)e;
  const size_t room = (size_t)optin - fa.sharedSizeBytes;
  int nw = min(EST_WARPS, C);
  while (nw > 1 && est_smem(nw, Wp) > room) --nw;
  const size_t smem = est_smem(nw, Wp);
  if (smem > room) return (int)cudaErrorInvalidValue;
  if ((e = cudaFuncSetAttribute(est_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return (int)e;
  est_kernel<<<B, nw * 32, smem, (cudaStream_t)stream>>>(
      Up, Vp, Nr, maskr, scal, ms, out, B, C, Wp);
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
  // each block takes live lanes off the list until it is empty
  int blocks = 0;
  const int rc = grid_blocks((const void*)sep_kernel<NR>, THREADS, smem, M,
                             &blocks);
  if (rc) return rc;
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
