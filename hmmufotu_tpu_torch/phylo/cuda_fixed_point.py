"""K5, the single-branch Felsenstein fixed point: the CUDA kernel hm_fp
(csrc/place.cu) beside its plain PyTorch version.

Counterpart of hmmufotu_tpu/phylo/placement.py `_fp_kernel` /
`_fixed_point_pallas`.  Per candidate lane, with the pre-scaled site
factors eA/eB (0 outside the informative sites) and their count n,

    p <- sum_w eB_w p / (eA_w (1 - p) + eB_w p) / n

is iterated until |log1p(-p') - log1p(-p)| < BRANCH_EPS, the iterate
leaves [0, 1], saturates at 1, or MAX_ITER steps have run (reference
optimizeBranchLength(u, v), PhyloTreeUnrooted.cpp:749-798).  A converged
lane is frozen, so each lane's result depends on that lane alone.  The
scaling before (placement._fixed_point_branch) and the branch length
-log1p(-p) after stay tensor ops.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _cuda
from .cuda_place import SAT_P
from .tree import BRANCH_EPS, MAX_ITER

FP_WARPS = 8                         # lanes per block (csrc/place.cu)
SMEM_LIMIT = 227 * 1024              # shared memory a block may use


def fixed_point_plain(eA, eB, n, p_init, skip):
    """Plain version of K5 over [M] lanes.  eA/eB [M, W] f32; n [M]
    informative-site counts (>= 1); p_init [M]; skip [M] bool lanes that
    start converged and return p_init.  Returns p [M] f32."""
    f32 = torch.float32
    eA, eB = eA.to(f32), eB.to(f32)
    n = n.to(f32)
    p = p_init.to(f32).clone()
    done = skip.to(torch.bool).clone()
    zero = torch.zeros((), dtype=f32, device=eA.device)
    for _ in range(MAX_ITER):
        if bool(done.all()):
            break
        num = eB * p[:, None]
        den = eA * (1.0 - p[:, None]) + num
        frac = torch.where(den > 0, num / den, zero)
        pn = frac.sum(1) / n
        bad = ~((pn >= 0) & (pn <= 1))
        diff = torch.abs(torch.log1p(-pn) - torch.log1p(-p))
        # f32 saturation guard: p -> 1 makes log1p(-p) = -inf and the
        # difference nan; a saturated lane counts as converged
        conv = (diff < BRANCH_EPS) | ~torch.isfinite(diff) | (pn >= SAT_P)
        p = torch.where(done | bad, p, pn)
        done = done | conv | bad
    return p


def fixed_point_cuda(eA, eB, n, p_init, skip):
    """Launch K5 (csrc/place.cu hm_fp); same contract as
    fixed_point_plain."""
    _cuda.require(eA, torch.float32, 2, "eA")
    _cuda.require(eB, torch.float32, 2, "eB")
    M, W = eA.shape
    if eB.shape != (M, W):
        raise ValueError("eA and eB must both be [M, W]")
    if FP_WARPS * 2 * W * 4 > SMEM_LIMIT:
        raise ValueError(f"window of {W} sites exceeds the kernel's "
                         "shared memory")
    if not n.numel() == p_init.numel() == skip.numel() == M:
        raise ValueError("n, p_init and skip must each hold M values")
    f = lambda x: x.reshape(-1).to(torch.float32)
    # per lane: n, p_init, skip flag (1.0 = return p_init), 0
    scal = torch.stack([f(n), f(p_init), f(skip), torch.zeros_like(f(n))],
                       dim=1).contiguous()
    out = torch.empty(M, dtype=torch.float32, device=eA.device)
    fn = _cuda.load_library("place").hm_fp
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    rc = fn(eA.data_ptr(), eB.data_ptr(), scal.data_ptr(), out.data_ptr(),
            M, W, _cuda.stream_ptr())
    _cuda.check_rc(rc, "fixed_point")
    if M:
        fixed_point_cuda.launches.add()
    return out


fixed_point_cuda.launches = _cuda.LaunchCounter()


def fixed_point(eA, eB, n, p_init, skip):
    """K5 on CUDA tensors, its plain version on CPU tensors."""
    fn = fixed_point_cuda if eA.device.type == "cuda" else fixed_point_plain
    return fn(eA, eB, n, p_init, skip)
