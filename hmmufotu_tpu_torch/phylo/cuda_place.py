"""SEP placement kernels: K2 (closed-form estimate) and K3 (joint
3-branch optimization), each as CUDA C++ (csrc/place.cu) beside its
plain PyTorch version.

Counterpart of hmmufotu_tpu/phylo/pallas_place.py.  Both read the
lanes' [4, W] up and down message windows in the kernel layout built by
pad_msgs / take_padded: [4, M, Wp] f32 planes (M = B*C candidate lanes,
Wp = W rounded up to 128).  K2 takes the leaf message and the site mask
once per read (pad_reads: [4, B, Wp] and [B, Wp]; lane m belongs to
read m // C), one CUDA block per read.  K3 takes them per lane
([4, M, Wp] and [M, Wp], from pad_msgs) and its blocks take the live
lanes one after the other off a list built on the device
(live_lane_list).

  * P(t) = U exp(lam t) U^-1 (the spectral form of every reference
    model, models.eig_tensors) convolved with the messages with the
    max-shift underflow scaling of dot_product_scaled
    (PhyloTreeUnrooted.h:1496-1504);
  * discrete-Gamma rate mixing (row_mean_exp_scaled, cpp:326-345);
  * the single-branch Felsenstein fixed points inside the outer
    3-branch loop with per-lane convergence (BRANCH_EPS, MAX_ITER) —
    reference optimizeBranchLength, PhyloTreeUnrooted.cpp:749-847.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _cuda
from .tree import BRANCH_EPS, MAX_ITER

N_MODEL_SCALARS = 64
# model_s layout: [0:16] U row-major, [16:32] U^-1 row-major,
# [32:36] lam, [36:40] log_pi, [40:48] dGamma rates
SAT_P = float(torch.tensor(1.0 - 1e-7, dtype=torch.float32))


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def model_scalars(Um, U_1, lam, log_pi, rates=None,
                  n_rates: int = 0) -> torch.Tensor:
    """Pack the spectral model into the kernels' [64] f32 vector."""
    dev = log_pi.device
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev) \
        .reshape(-1)
    m = torch.zeros(N_MODEL_SCALARS, dtype=torch.float32, device=dev)
    m[0:16] = f(Um)
    m[16:32] = f(U_1)
    m[32:36] = f(lam)
    m[36:40] = f(log_pi)
    if n_rates:
        m[40:40 + n_rates] = f(rates)[:n_rates]
    return m


def pad_msgs(U, V, Nl, site_ok):
    """[B, C, 4, W] message windows + [B, C, W] mask -> the kernels'
    [4, M, Wp] planes and [M, Wp] f32 mask (M = B*C lanes, Wp = W
    rounded up to 128, zero padded)."""
    B, C, _, W = U.shape
    M = B * C
    Wp = _round_up(W, 128)
    dev = U.device

    def pad_msg(X):
        out = torch.zeros((4, M, Wp), dtype=torch.float32, device=dev)
        out[:, :, :W] = X.reshape(M, 4, W).transpose(0, 1)
        return out

    maskp = torch.zeros((M, Wp), dtype=torch.float32, device=dev)
    maskp[:, :W] = site_ok.reshape(M, W)
    return pad_msg(U), pad_msg(V), pad_msg(Nl), maskp


def pad_reads(leaf, site_ok):
    """[B, 4, W] leaf messages + [B, W] mask of a batch's reads -> K2's
    per-read [4, B, Wp] plane and [B, Wp] f32 mask, zero padded as
    pad_msgs pads the lanes."""
    B, _, W = leaf.shape
    Wp = _round_up(W, 128)
    Nr = torch.zeros((4, B, Wp), dtype=torch.float32, device=leaf.device)
    Nr[:, :, :W] = leaf.transpose(0, 1)
    maskr = torch.zeros((B, Wp), dtype=torch.float32, device=leaf.device)
    maskr[:, :W] = site_ok
    return Nr, maskr


def take_padded(padded, order, C: int):
    """Compact padded lanes to a new candidate order: order [B, k] of
    per-read candidate ranks -> [4, B*k, Wp] planes and [B*k, Wp] mask."""
    Up, Vp, Np, maskp = padded
    B = order.shape[0]
    flat = (torch.arange(B, device=order.device)[:, None] * C
            + order).reshape(-1)
    return (Up.index_select(1, flat), Vp.index_select(1, flat),
            Np.index_select(1, flat), maskp.index_select(0, flat))


# ---------------------------------------------------------------------------
# plain PyTorch versions (the arithmetic of csrc/place.cu, lanes batched)
# ---------------------------------------------------------------------------

def _finite_guard(m):
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def _max4(msg):
    return torch.maximum(torch.maximum(msg[0], msg[1]),
                         torch.maximum(msg[2], msg[3]))


def _conv_one(ms, msg, t):
    """log(P(t) @ exp(msg)) per site; msg = 4 [M, W] planes, t [M, 1]."""
    e = [torch.exp(ms[32 + j] * t) for j in range(4)]
    scale = _finite_guard(_max4(msg))
    em = [torch.exp(msg[l] - scale) for l in range(4)]
    out = []
    for k in range(4):
        acc = None
        for l in range(4):
            p_kl = None
            for j in range(4):
                term = (ms[k * 4 + j] * ms[16 + j * 4 + l]) * e[j]
                p_kl = term if p_kl is None else p_kl + term
            p_kl = torch.clamp(p_kl, min=0.0)
            v = p_kl * em[l]
            acc = v if acc is None else acc + v
        out.append(torch.log(acc) + scale)
    return out


def _dot_vec(ms, msg):
    """log(pi . exp(msg)) per site."""
    scale = _finite_guard(_max4(msg))
    s = None
    for k in range(4):
        v = torch.exp(ms[36 + k] + msg[k] - scale)
        s = v if s is None else s + v
    return torch.log(s) + scale


def _argmax4(planes):
    """first-index max over 4 planes"""
    best = planes[0]
    idx = torch.zeros_like(best, dtype=torch.int64)
    for k in range(1, 4):
        upd = planes[k] > best
        idx = torch.where(upd, k, idx)
        best = torch.maximum(best, planes[k])
    return idx


def _check_est(Up, Vp, Nr, maskr, wur0, wvr0, C: int):
    """K2's shapes: Up/Vp [4, M, Wp] per lane, Nr [4, B, Wp] and maskr
    [B, Wp] per read, wur0/wvr0 [M], with M = B * C."""
    if Up.dim() != 3 or Up.shape[0] != 4 or Vp.shape != Up.shape:
        raise ValueError("U and V must both be [4, M, Wp]")
    _, M, Wp = Up.shape
    if maskr.dim() != 2 or maskr.shape[1] != Wp:
        raise ValueError("mask must be [B, Wp], per read")
    B = maskr.shape[0]
    if Nr.shape != (4, B, Wp):
        raise ValueError("N must be [4, B, Wp], per read")
    if M != B * C:
        raise ValueError(f"{M} lanes are not B * C = {B} * {C}")
    if wur0.numel() != M or wvr0.numel() != M:
        raise ValueError("wur0 and wvr0 must each hold M values")


def est_plain(Up, Vp, Nr, maskr, wur0, wvr0, model_s, C: int):
    """Plain version of K2.  Up/Vp [4, M, Wp] per lane; Nr [4, B, Wp]
    and maskr [B, Wp] per read, lane m of read m // C; wur0/wvr0 [M].
    Returns (est_loglik [M], wnr0 [M]): the closed-form estimate at the
    initial split and the unweighted initial pendant length (reference
    estimateSeq, PhyloTreeUnrooted.cpp:861-871, cpp:1018-1031).  Values
    of U and V at unmasked sites do not reach the result."""
    _check_est(Up, Vp, Nr, maskr, wur0, wvr0, C)
    ms = model_s
    mask = (maskr > 0.5).repeat_interleave(C, dim=0)
    U = [Up[k] for k in range(4)]
    V = [Vp[k] for k in range(4)]
    N = [Nr[k].repeat_interleave(C, dim=0) for k in range(4)]
    UPr = _conv_one(ms, U, wur0[:, None])
    VPr = _conv_one(ms, V, wvr0[:, None])
    R0 = [UPr[k] + VPr[k] for k in range(4)]
    b1 = _argmax4(R0)
    b2 = _argmax4(N)
    one = torch.ones((), dtype=torch.float32, device=Up.device)
    zero = torch.zeros((), dtype=torch.float32, device=Up.device)
    nsites = torch.clamp(torch.where(mask, one, zero).sum(1), min=1.0)
    wnr0 = torch.where(mask & (b1 != b2), one, zero).sum(1) / nsites
    NPr = _conv_one(ms, N, wnr0[:, None])
    cols = _dot_vec(ms, [R0[k] + NPr[k] for k in range(4)])
    est = torch.where(mask, cols, zero).sum(1)
    return est, wnr0


def _conv_mix(ms, pairs, n_rates: int):
    outs = []
    for r in range(n_rates):
        rate = ms[40 + r]
        s = None
        for msg, t in pairs:
            c = _conv_one(ms, msg, t * rate)
            s = c if s is None else [s[k] + c[k] for k in range(4)]
        outs.append(s)
    if n_rates == 1:
        return outs[0]
    res = []
    for k in range(4):
        planes = [outs[r][k] for r in range(n_rates)]
        m = planes[0]
        for p_ in planes[1:]:
            m = torch.maximum(m, p_)
        scale = _finite_guard(m)
        s = None
        for p_ in planes:
            v = torch.exp(p_ - scale)
            s = v if s is None else s + v
        res.append(torch.log(s / float(n_rates)) + scale)
    return res


def sep_plain(Up, Vp, Np, maskp, w0, wur0, wnr0, live, model_s,
              n_rates: int):
    """Plain version of K3 over [M] lanes.  Returns (wur, wvr, wnr,
    loglik, outer_trips, inner_trips), each [M] f32; dead lanes (not
    live) are all zero, as the kernel leaves them."""
    M = w0.shape[0]
    dev = w0.device
    out = torch.zeros((6, M), dtype=torch.float32, device=dev)
    idx = torch.nonzero(live.reshape(-1)).reshape(-1)
    if idx.numel() == 0:
        return tuple(out)
    ms = model_s
    mask = maskp.index_select(0, idx) > 0.5
    U = [Up[k].index_select(0, idx) for k in range(4)]
    V = [Vp[k].index_select(0, idx) for k in range(4)]
    N = [Np[k].index_select(0, idx) for k in range(4)]
    w0 = w0[idx][:, None]
    wur = wur0[idx][:, None]
    wnr = wnr0[idx][:, None]
    m = idx.numel()
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)

    def fp(Rm, Xm, w_cur, max_len, skip):
        logA = _dot_vec(ms, [Rm[k] + Xm[k] for k in range(4)])
        logB = _dot_vec(ms, Rm) + _dot_vec(ms, Xm)
        ok = mask & ~(torch.isnan(logA) | torch.isnan(logB))
        scale = torch.maximum(logA, logB)
        eA = torch.where(ok, torch.exp(logA - scale), zero)
        eB = torch.where(ok, torch.exp(logB - scale), zero)
        n = torch.clamp(torch.where(ok, one, zero).sum(1, keepdim=True),
                        min=1.0)
        p = 1.0 - torch.exp(-w_cur)
        done = skip.clone()
        trips = torch.zeros((m, 1), dtype=torch.float32, device=dev)
        for _ in range(MAX_ITER):
            if bool(done.all()):
                break
            trips = trips + (~done).to(torch.float32)
            num = eB * p
            den = eA * (1.0 - p) + num
            frac = torch.where(den > 0, num / den, zero)
            pn = frac.sum(1, keepdim=True) / n
            bad = ~((pn >= 0) & (pn <= 1))
            diff = torch.abs(torch.log1p(-pn) - torch.log1p(-p))
            conv = (diff < BRANCH_EPS) | ~torch.isfinite(diff) \
                | (pn >= SAT_P)
            p = torch.where(done | bad, p, pn)
            done = done | conv | bad
        return torch.minimum(-torch.log1p(-p), max_len), trips

    wvr = w0 - wur
    done = torch.zeros((m, 1), dtype=torch.bool, device=dev)
    o_trips = torch.zeros((m, 1), dtype=torch.float32, device=dev)
    i_trips = torch.zeros((m, 1), dtype=torch.float32, device=dev)
    ones = torch.ones_like(wnr)
    for _ in range(MAX_ITER):
        if bool(done.all()):
            break
        o_trips = o_trips + (~done).to(torch.float32)
        Rn = _conv_mix(ms, [(U, wur), (V, wvr)], n_rates)
        wnr_n, t1 = fp(Rn, N, wnr, ones, done)
        Ru = _conv_mix(ms, [(V, wvr), (N, wnr_n)], n_rates)
        wur_n, t2 = fp(Ru, U, wur, w0, done)
        i_trips = i_trips + t1 + t2
        wvr_n = w0 - wur_n
        convd = (torch.abs(wur_n - wur) < BRANCH_EPS) \
            & (torch.abs(wnr_n - wnr) < BRANCH_EPS)
        bad = ~((wur_n >= 0) & (wur_n <= w0))
        wur = torch.where(done, wur, wur_n)
        wvr = torch.where(done, wvr, wvr_n)
        wnr = torch.where(done, wnr, wnr_n)
        done = done | convd | bad
    root = _conv_mix(ms, [(U, wur), (V, wvr), (N, wnr)], n_rates)
    cols = _dot_vec(ms, root)
    ll = torch.where(mask, cols, zero).sum(1, keepdim=True)
    res = torch.cat([wur, wvr, wnr, ll, o_trips, i_trips], dim=1)
    out[:, idx] = res.t()
    return tuple(out)


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

def _check_layout(Up, Vp, Np, maskp):
    for t, name in ((Up, "U"), (Vp, "V"), (Np, "N")):
        _cuda.require(t, torch.float32, 3, name)
        if t.shape != Up.shape or t.shape[0] != 4:
            raise ValueError(f"{name} must be [4, M, Wp] like U")
    _cuda.require(maskp, torch.float32, 2, "mask")
    if maskp.shape != Up.shape[1:]:
        raise ValueError("mask must be [M, Wp]")


def _fn(name, n_ptr, n_int):
    fn = getattr(_cuda.load_library("place"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    return fn


def est_cuda(Up, Vp, Nr, maskr, wur0, wvr0, model_s, C: int):
    """Launch K2 (csrc/place.cu hm_est); same contract as est_plain.
    The kernel loads U and V only at the sites the read's mask keeps."""
    _check_est(Up, Vp, Nr, maskr, wur0, wvr0, C)
    for t, name in ((Up, "U"), (Vp, "V"), (Nr, "N")):
        _cuda.require(t, torch.float32, 3, name)
    _cuda.require(maskr, torch.float32, 2, "mask")
    _cuda.require(model_s, torch.float32, 1, "model_s")
    B, Wp = maskr.shape
    M = B * C
    scal = torch.stack([wur0.reshape(-1), wvr0.reshape(-1)], dim=1) \
        .to(torch.float32).contiguous()
    out = torch.empty((M, 2), dtype=torch.float32, device=Up.device)
    _cuda.launch(
        "est", _fn("hm_est", 7, 3), Up,
        Up.data_ptr(), Vp.data_ptr(), Nr.data_ptr(), maskr.data_ptr(),
        scal.data_ptr(), model_s.data_ptr(), out.data_ptr(), B, C, Wp)
    if M:
        est_cuda.launches.add()
    return out[:, 0], out[:, 1]


est_cuda.launches = _cuda.LaunchCounter()


def live_lane_list(live):
    """(lanes [M + 1] int32, ctrl [2] int32) of a K3 launch, built on the
    device without a host round trip: the indices of the live lanes in
    order in lanes[:n_live], and ctrl = (n_live, 0), the kernel's work
    counter starting at 0.  K5 builds its list inside its launch
    (fp_list_kernel), because its kernel is shorter than the host's
    enqueue of these few ops; a K3 launch takes 1 to 7 ms on the device,
    which hides them."""
    lv = live.reshape(-1).to(torch.bool)
    M = lv.shape[0]
    dev = lv.device
    pos = torch.cumsum(lv, 0, dtype=torch.int64)
    slot = torch.where(lv, pos - 1, M)          # dead lanes to a spare slot
    lanes = torch.empty(M + 1, dtype=torch.int32, device=dev)
    lanes.scatter_(0, slot, torch.arange(M, dtype=torch.int32, device=dev))
    ctrl = torch.zeros(2, dtype=torch.int32, device=dev)
    if M:
        ctrl[0] = pos[-1]
    return lanes, ctrl


def sep_cuda(Up, Vp, Np, maskp, w0, wur0, wnr0, live, model_s,
             n_rates: int):
    """Launch K3 (csrc/place.cu hm_sep); same contract as sep_plain."""
    _check_layout(Up, Vp, Np, maskp)
    if n_rates not in (1, 4):
        raise ValueError("the kernel is built for 1 or 4 Gamma rates")
    M, Wp = maskp.shape
    f = lambda x: x.reshape(-1).to(torch.float32)
    scal = torch.stack([f(w0), f(wur0), f(wnr0)], dim=1).contiguous()
    _cuda.require(model_s, torch.float32, 1, "model_s")
    if live.device != Up.device or live.numel() != M:
        raise ValueError("live must be [M] on the messages' device")
    lanes, ctrl = live_lane_list(live)
    out = torch.zeros((M, 8), dtype=torch.float32, device=Up.device)
    _cuda.launch(
        "sep", _fn("hm_sep", 9, 3), Up,
        Up.data_ptr(), Vp.data_ptr(), Np.data_ptr(), maskp.data_ptr(),
        scal.data_ptr(), model_s.data_ptr(), lanes.data_ptr(),
        ctrl.data_ptr(), out.data_ptr(), M, Wp, n_rates)
    if M:
        sep_cuda.launches.add()
    return tuple(out[:, q] for q in range(6))


sep_cuda.launches = _cuda.LaunchCounter()


def est(Up, Vp, Nr, maskr, wur0, wvr0, model_s, C: int):
    """K2 on CUDA tensors, its plain version on CPU tensors."""
    fn = est_cuda if Up.device.type == "cuda" else est_plain
    return fn(Up, Vp, Nr, maskr, wur0, wvr0, model_s, C)


def sep_optimize(Up, Vp, Np, maskp, w0, wur0, wnr0, live, model_s,
                 n_rates: int):
    """K3 on CUDA tensors, its plain version on CPU tensors."""
    fn = sep_cuda if Up.device.type == "cuda" else sep_plain
    return fn(Up, Vp, Np, maskp, w0, wur0, wnr0, live, model_s, n_rates)
