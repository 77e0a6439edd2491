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
-log1p(-p) after stay tensor ops.  A lane's terms are summed by a fixed
halving tree over the site positions (tree_sum) in the kernel and in the
plain version alike, so on the card the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _cuda
from .cuda_place import SAT_P
from .tree import BRANCH_EPS, MAX_ITER


TREE_LEAVES = 128       # threads of a K5 lane (csrc/place.cu THREADS)
MAX_WINDOW = 64 * TREE_LEAVES   # sites a K5 lane holds in registers


def tree_sum(x):
    """Sum over the last dimension by a fixed halving tree: x padded with
    zeros to 128 * 2^k columns, then x[..., :h] + x[..., h:] until one
    column is left.  The kernel adds a lane's terms in this order, so
    both sum them to the same bits."""
    W = x.shape[-1]
    Wt = TREE_LEAVES
    while Wt < W:
        Wt *= 2
    x = torch.nn.functional.pad(x, (0, Wt - W))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def fixed_point_plain(eA, eB, n, p_init, skip):
    """Plain version of K5 over [M] lanes.  eA/eB [M, W] f32; n [M]
    informative-site counts (>= 1); p_init [M]; skip [M] bool lanes that
    start converged and return p_init.  Returns p [M] f32.  A lane's
    terms are summed by tree_sum, as the kernel sums them."""
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
        pn = tree_sum(frac) / n
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
    fixed_point_plain, for windows up to 8,192 sites.  One C call: a
    small kernel lists the lanes not skipped on the device and writes
    p_init for the others, then each listed lane takes a 128-thread block
    that holds its sites in registers.  No host sync, and no tensor op
    beyond the inputs' casts: the list is built in the launch."""
    _cuda.require(eA, torch.float32, 2, "eA")
    _cuda.require(eB, torch.float32, 2, "eB")
    M, W = eA.shape
    if eB.shape != (M, W):
        raise ValueError("eA and eB must both be [M, W]")
    if not n.numel() == p_init.numel() == skip.numel() == M:
        raise ValueError("n, p_init and skip must each hold M values")
    if W > MAX_WINDOW:
        raise ValueError(f"window of {W} sites exceeds the kernel's "
                         f"{MAX_WINDOW}")
    f = lambda x: x.reshape(-1).to(torch.float32).contiguous()
    nf, p0 = f(n), f(p_init)
    sk = skip.reshape(-1).to(torch.bool).contiguous()
    dev = eA.device
    lanes = torch.empty(M, dtype=torch.int32, device=dev)
    ctrl = torch.empty(2, dtype=torch.int32, device=dev)
    out = torch.empty(M, dtype=torch.float32, device=dev)
    fn = _cuda.load_library("place").hm_fp
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    _cuda.launch("fixed_point", fn, eA,
                 eA.data_ptr(), eB.data_ptr(), nf.data_ptr(), p0.data_ptr(),
                 sk.data_ptr(), lanes.data_ptr(), ctrl.data_ptr(),
                 out.data_ptr(), M, W)
    if M:
        fixed_point_cuda.launches.add()
    return out


fixed_point_cuda.launches = _cuda.LaunchCounter()


def fixed_point(eA, eB, n, p_init, skip):
    """K5 on CUDA tensors, its plain version on CPU tensors."""
    fn = fixed_point_cuda if eA.device.type == "cuda" else fixed_point_plain
    return fn(eA, eB, n, p_init, skip)
