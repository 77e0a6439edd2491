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
// the loop trip counts.  A lane that is not live writes zeros.
//
// K5 hm_fp replaces hmmufotu_tpu/phylo/placement.py `_fp_kernel`
// (_fixed_point_pallas): the single-branch Felsenstein fixed point
// p <- sum_w eB_w p / (eA_w (1 - p) + eB_w p) / n on site factors that the
// caller pre-scaled, to convergence per lane.  It serves the placer whose
// outer 3-branch loop and rate-mixed convolutions stay tensor ops.
//
// What bounds them on the H100: K2 is bound by transcendentals (per site
// ~12 expf + 8 logf and ~200 flops over 48 B of messages, far above the
// card's bytes-per-flop line).  K3 is bound by the serial iteration chain
// of each live lane: every inner fixed-point step ends in a block-wide
// sum, and only ~2% of lanes are live after the estimate filter.  K5 is
// bound by bytes on paper (a live lane's two W-site rows read once, 2 flops
// a byte per trip over ~10-30 trips); in fact by the latency of each
// lane's dependent chain of divide, warp sum and two log1pf a trip, and by
// the few lanes that are live.
//
// Design: one block per candidate lane, threads over the W sites, block
// reductions for the counts and sums.  All per-site work of a step is
// local to the site, so the rate-mixed convolutions are computed per site
// in registers and never stored; K3 keeps the lane's messages and its
// fixed-point site factors in shared memory across the iterations.  A
// dead K3 block returns at once.  K5 takes one warp per lane: the TPU
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
__device__ __forceinline__ float dot_vec(const Model& md, const float* msg) {
  const float scale = guard(max4(msg));
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v = expf(md.logpi[k] + msg[k] - scale);
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
    const float col = dot_vec(md, x);
    acc += maskp[row + w] > 0.5f ? col : 0.0f;
  }
  const float est = block_sum(acc, red);
  if (threadIdx.x == 0) {
    out[2 * m] = est;
    out[2 * m + 1] = wnr0;
  }
}

// rate-mixed summed convolution at one site of NP (message, e) pairs;
// e holds exp(lam_j * t_p * rate_r) at [(p * NR + r) * 4 + j]
template <int NR, int NP>
__device__ __forceinline__ void conv_mix(const Model& md,
                                         const float* const* msg,
                                         const float* e, float* out) {
  float s[NR][4];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float c[4];
      conv_one(md, msg[p], e + (p * NR + r) * 4, c);
#pragma unroll
      for (int k = 0; k < 4; ++k) s[r][k] = p == 0 ? c[k] : s[r][k] + c[k];
    }
  }
  if (NR == 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = s[0][k];
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float mx = s[0][k];
#pragma unroll
    for (int r = 1; r < NR; ++r) mx = fmaxf(mx, s[r][k]);
    const float scale = guard(mx);
    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float v = expf(s[r][k] - scale);
      acc = r == 0 ? v : acc + v;
    }
    out[k] = logf(acc / (float)NR) + scale;
  }
}

template <int NR, int NP>
__device__ __forceinline__ void rate_factors(const Model& md,
                                             const float* t, float* e) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        e[(p * NR + r) * 4 + j] = expf(md.lam[j] * (t[p] * md.rates[r]));
}

// fixed point of one branch given the per-site factors eA/eB in shared
// memory (reference optimizeBranchLength(u,v), cpp:749-798)
__device__ float fixed_point(const float* eA, const float* eB, float n,
                             float w_cur, float max_len, int Wp, float* red,
                             int* trips) {
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
    const float pn = block_sum(part, red) / n;
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

template <int NR>
__global__ void sep_kernel(const float* __restrict__ Up,
                           const float* __restrict__ Vp,
                           const float* __restrict__ Np,
                           const float* __restrict__ maskp,
                           const float* __restrict__ scal,
                           const float* __restrict__ ms,
                           float* __restrict__ out, int M, int Wp) {
  extern __shared__ float sm[];
  float* U_s = sm;               // [4][Wp] each
  float* V_s = U_s + 4 * Wp;
  float* N_s = V_s + 4 * Wp;
  float* mask_s = N_s + 4 * Wp;  // [Wp]
  float* eA_s = mask_s + Wp;
  float* eB_s = eA_s + Wp;
  __shared__ float red[32];
  const int m = blockIdx.x;
  float* o = out + (size_t)m * 8;
  if (scal[4 * m + 3] > 0.5f) {  // dead lane
    if (threadIdx.x < 8) o[threadIdx.x] = 0.0f;
    return;
  }
  Model md;
  load_model(ms, md);
  const size_t plane = (size_t)M * Wp, row = (size_t)m * Wp;
  for (int w = threadIdx.x; w < Wp; w += blockDim.x) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      U_s[k * Wp + w] = Up[k * plane + row + w];
      V_s[k * Wp + w] = Vp[k * plane + row + w];
      N_s[k * Wp + w] = Np[k * plane + row + w];
    }
    mask_s[w] = maskp[row + w];
  }
  __syncthreads();
  const float w0 = scal[4 * m];
  float wur = scal[4 * m + 1], wnr = scal[4 * m + 2];
  float wvr = w0 - wur;
  int o_trips = 0, i_trips = 0;

  // fills eA_s/eB_s for the branch whose far side is X, near side the
  // rate-mixed convolution of the NP pairs; returns the informative-site
  // count n
  auto setup = [&](const float* P0, float t0, const float* P1, float t1,
                   const float* X) -> float {
    float tt[2] = {t0, t1};
    float e[2 * NR * 4];
    rate_factors<NR, 2>(md, tt, e);
    float cnt = 0.0f;
    for (int w = threadIdx.x; w < Wp; w += blockDim.x) {
      float a[4], b[4], x[4], r[4], rx[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a[k] = P0[k * Wp + w];
        b[k] = P1[k * Wp + w];
        x[k] = X[k * Wp + w];
      }
      const float* msg[2] = {a, b};
      conv_mix<NR, 2>(md, msg, e, r);
#pragma unroll
      for (int k = 0; k < 4; ++k) rx[k] = r[k] + x[k];
      const float logA = dot_vec(md, rx);
      const float logB = dot_vec(md, r) + dot_vec(md, x);
      const bool ok = mask_s[w] > 0.5f && !(isnan(logA) || isnan(logB));
      const float scale = fmaxf(logA, logB);
      eA_s[w] = ok ? expf(logA - scale) : 0.0f;
      eB_s[w] = ok ? expf(logB - scale) : 0.0f;
      cnt += ok ? 1.0f : 0.0f;
    }
    return fmaxf(block_sum(cnt, red), 1.0f);  // syncs: eA_s/eB_s visible
  };

  for (int it = 0; it < MAX_ITER; ++it) {
    ++o_trips;
    float n = setup(U_s, wur, V_s, wvr, N_s);
    const float wnr_n = fixed_point(eA_s, eB_s, n, wnr, 1.0f, Wp, red,
                                    &i_trips);
    __syncthreads();  // every thread done with eA_s/eB_s
    n = setup(V_s, wvr, N_s, wnr_n, U_s);
    const float wur_n = fixed_point(eA_s, eB_s, n, wur, w0, Wp, red,
                                    &i_trips);
    __syncthreads();
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
  float tt[3] = {wur, wvr, wnr};
  float e[3 * NR * 4];
  rate_factors<NR, 3>(md, tt, e);
  float acc = 0.0f;
  for (int w = threadIdx.x; w < Wp; w += blockDim.x) {
    float a[4], b[4], c[4], r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a[k] = U_s[k * Wp + w];
      b[k] = V_s[k * Wp + w];
      c[k] = N_s[k * Wp + w];
    }
    const float* msg[3] = {a, b, c};
    conv_mix<NR, 3>(md, msg, e, r);
    const float col = dot_vec(md, r);
    acc += mask_s[w] > 0.5f ? col : 0.0f;
  }
  const float ll = block_sum(acc, red);
  if (threadIdx.x == 0) {
    o[0] = wur;
    o[1] = wvr;
    o[2] = wnr;
    o[3] = ll;
    o[4] = (float)o_trips;
    o[5] = (float)i_trips;
    o[6] = 0.0f;
    o[7] = 0.0f;
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
                      float* out, int M, int Wp, cudaStream_t st) {
  const size_t smem = (size_t)15 * Wp * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      sep_kernel<NR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  sep_kernel<NR><<<M, THREADS, smem, st>>>(Up, Vp, Np, maskp, scal, ms, out,
                                           M, Wp);
  return (int)cudaGetLastError();
}

extern "C" int hm_sep(const float* Up, const float* Vp, const float* Np,
                      const float* maskp, const float* scal, const float* ms,
                      float* out, int M, int Wp, int n_rates, void* stream) {
  if (M == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_rates == 1)
    return launch_sep<1>(Up, Vp, Np, maskp, scal, ms, out, M, Wp, st);
  if (n_rates == 4)
    return launch_sep<4>(Up, Vp, Np, maskp, scal, ms, out, M, Wp, st);
  return (int)cudaErrorInvalidValue;
}
