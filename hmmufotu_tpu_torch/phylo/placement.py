"""Batched SEP placement on the device (PyTorch).

Counterpart of hmmufotu_tpu/phylo/placement.py (reference:
src/HmmUFOtu_main.cpp:127-216 seed/estimate/filter/place,
src/PhyloTreeUnrooted.cpp:749-954 the joint 3-branch optimization).  A
whole read batch x candidate grid runs at once:

  seed     : masked-mismatch p-dist of every read against every node
             sequence as one one-hot matrix product, then top-C
             (getSeed, HmmUFOtu_main.cpp:127-152)
  estimate : closed form at all B x C candidate branches (estimateSeq):
             kernel K2, or tensor ops (est_kernel=False)
  filter   : loglik mask vs the per-read best (filterPlacements)
  place    : the joint 3-branch fixed point with per-lane convergence
             (optimizeBranchLength): kernel K3 (sep_kernel=True), or an
             outer loop of tensor ops whose inner single-branch fixed
             points run in kernel K5 (fp_kernel=True) or in a tensor-op
             loop
  Q values : per-read posteriors with per-taxon grouping (calcQValues)

Site windows are fixed-width slices (W) with validity masks.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .._cuda import resolve_device
from .cuda_place import SAT_P, _finite_guard
from .tree import BRANCH_EPS, MAX_ITER, PTUnrooted

INF = float("inf")
# host bytes of the f32 block a message upload stages at once
UPLOAD_CHUNK_BYTES = 256 << 20
# device bytes of one node block of the seed product's operand planes:
# at a full-width union window over every node of the gg_97 shape
# (149,999 x 6,000 columns) the whole planes would take ~31 GB
PDIST_CHUNK_BYTES = 1 << 30
# bytes a node's planes take per window column: the bool, bf16 and f32
# copies of the 4 one-hot planes and of the validity plane
PDIST_BYTES_PER_COL = 5 * (1 + 2 + 4)


class DeviceTree(NamedTuple):
    """Tree/DB arrays as tensors on one device."""
    msg_up: torch.Tensor     # [N, 4, Lw] f32/bf16 (Lw = L or site window)
    msg_down: torch.Tensor   # [N, 4, Lw]
    seqs: torch.Tensor       # [N, Lw] int8
    brlen: torch.Tensor      # [N]
    heights: torch.Tensor    # [N]
    parent: torch.Tensor     # [N] int64
    anno_dist: torch.Tensor  # [N] taxonomy annotation distances
    anno_id: torch.Tensor    # [N] int64 id of each node's taxon STRING
    pi: torch.Tensor         # [4]
    log_pi: torch.Tensor     # [4]
    rates: torch.Tensor      # [K] discrete-Gamma rates (or [1.0])
    msg_s0: int              # CS site of msg/seqs column 0
    seq1h: torch.Tensor | None = None    # [N, Lw*4] int8 one-hot window
    nvalid: torch.Tensor | None = None   # [N, Lw] int8 validity window

    @classmethod
    def from_tree(cls, tree: PTUnrooted, device, msg_dtype=None,
                  site_window: tuple[int, int] | None = None
                  ) -> "DeviceTree":
        """msg_dtype: storage dtype of the per-edge message tensors (the
        memory-dominant [N, 4, L] pair; torch.bfloat16 halves it and
        compute stays f32).  site_window=(s0, Ws): stage only CS columns
        [s0, s0+Ws) of the message/sequence tensors, with the node-seq
        one-hot planes of the seed product precomputed."""
        dev = torch.device(device)
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                      device=dev)
        rates = np.ones(1) if tree.dg is None \
            else np.asarray(tree.dg.rates)
        s0 = 0
        sl = slice(None)
        seqs = tree.seqs
        seq1h = nvalid = None
        if site_window is not None:
            s0, Ws = site_window
            sl = slice(s0, s0 + Ws)
            seqs = np.ascontiguousarray(tree.seqs[:, sl])
            one_hot = (seqs[:, :, None]
                       == np.arange(4, dtype=np.int8)).astype(np.int8)
            seq1h = torch.as_tensor(one_hot.reshape(len(seqs), -1),
                                    device=dev)
            nvalid = torch.as_tensor((seqs >= 0).astype(np.int8),
                                     device=dev)
        fm = lambda a: upload_messages(a[:, :, sl], dev,
                                       msg_dtype or torch.float32)
        return cls(
            msg_up=fm(tree.msg_up), msg_down=fm(tree.msg_down),
            seqs=torch.as_tensor(np.asarray(seqs, np.int8), device=dev),
            brlen=f(tree.brlen), heights=f(tree.heights),
            parent=torch.as_tensor(np.asarray(tree.parent, np.int64),
                                   device=dev),
            anno_dist=f(tree.anno_dist),
            anno_id=torch.as_tensor(anno_ids(tree), device=dev),
            pi=f(tree.model.pi), log_pi=f(np.log(tree.model.pi)),
            rates=f(rates), msg_s0=int(s0), seq1h=seq1h, nvalid=nvalid)


def upload_messages(msg: np.ndarray, device, dtype) -> torch.Tensor:
    """[N, 4, Lw] host messages (any float dtype, a view is fine) as a
    `dtype` tensor on `device`, filled one node block at a time: each
    block is rounded to f32 on the host, then to `dtype` on the device,
    so no f32 copy of the whole array is made on the host (14.4 GB per
    message at the gg_97 shape).  The values are those of one whole
    conversion."""
    out = torch.empty(msg.shape, dtype=dtype, device=device)
    step = max(1, UPLOAD_CHUNK_BYTES
               // max(1, 4 * int(np.prod(msg.shape[1:]))))
    for n0 in range(0, len(msg), step):
        block = np.asarray(msg[n0:n0 + step], np.float32)
        out[n0:n0 + len(block)] = torch.as_tensor(
            block, device=device).to(dtype)
    return out


def anno_ids(tree: PTUnrooted) -> np.ndarray:
    """[N] int64 dense id of each node's taxon string, in first-seen node
    order."""
    taxa: dict[str, int] = {}
    return np.array([taxa.setdefault(a, len(taxa)) for a in tree.anno],
                    dtype=np.int64)


def _dot_scaled(P: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """log(P @ exp(V)) columnwise with underflow scaling.

    P [..., 4, 4], V [..., 4, W] -> [..., 4, W]
    (reference dot_product_scaled, PhyloTreeUnrooted.h:1496-1504).  The
    product stays full f32 (resolve_device turns TF32 off)."""
    scale = _finite_guard(V.max(dim=-2, keepdim=True).values)
    return torch.log(P @ torch.exp(V - scale)) + scale


def _dot_scaled_vec(log_p: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """log(pi . exp(V)) per column; V [..., 4, W] -> [..., W]."""
    scale = _finite_guard(V.max(dim=-2, keepdim=True).values)
    s = torch.exp(log_p[..., :, None] + V - scale).sum(dim=-2)
    return torch.log(s) + scale[..., 0, :]


def _conv_mix(pr_fn, rates: torch.Tensor, msgs) -> torch.Tensor:
    """Rate-mixed convolution sum (reference loglik + row_mean_exp,
    PhyloTreeUnrooted.cpp:326-345).

    msgs: list of (msg [..., 4, W], branch_length [...]).
    Returns the averaged summed message [..., 4, W]."""
    outs = []
    for r in rates:
        s = None
        for msg, bl in msgs:
            conv = _dot_scaled(pr_fn(bl * r), msg)
            s = conv if s is None else s + conv
        outs.append(s)
    if len(outs) == 1:
        return outs[0]
    X = torch.stack(outs, dim=-1)              # [..., 4, W, K]
    del outs
    scale = _finite_guard(X.max(dim=-1, keepdim=True).values)
    return torch.log(torch.exp(X - scale).mean(dim=-1)) + scale[..., 0]


def _fixed_point_branch(log_pi, U, V, w0, site_mask, max_len, skip=None,
                        use_kernel: bool = False) -> torch.Tensor:
    """Batched Felsenstein single-branch fixed point
    (reference optimizeBranchLength(u,v), PhyloTreeUnrooted.cpp:749-798).

    U, V: [..., 4, W]; w0, max_len: [...]; site_mask: [..., W].
    skip: [...] bool lanes whose result the caller discards (they start
    converged, so they never hold the batch back).
    use_kernel: run the iteration in kernel K5 (cuda_fixed_point), else
    as a loop of tensor ops.  Returns the optimized branch length [...].
    """
    logA = _dot_scaled_vec(log_pi, U + V)              # [..., W]
    logB = _dot_scaled_vec(log_pi, U) + _dot_scaled_vec(log_pi, V)
    ok = site_mask & ~(torch.isnan(logA) | torch.isnan(logB))
    scale = torch.maximum(logA, logB)
    zero = torch.zeros((), dtype=logA.dtype, device=logA.device)
    eA = torch.where(ok, torch.exp(logA - scale), zero)
    eB = torch.where(ok, torch.exp(logB - scale), zero)
    del logA, logB, scale
    n = torch.clamp(ok.sum(dim=-1), min=1)
    p = 1.0 - torch.exp(-w0)
    done = torch.zeros_like(p, dtype=torch.bool) if skip is None else skip

    if use_kernel:
        from .cuda_fixed_point import fixed_point
        W = eA.shape[-1]
        p = fixed_point(eA.reshape(-1, W), eB.reshape(-1, W),
                        n.reshape(-1), p.reshape(-1),
                        done.reshape(-1)).reshape(p.shape)
        return torch.minimum(-torch.log1p(-p), max_len)

    for _ in range(MAX_ITER):
        if bool(done.all()):
            break
        num = eB * p[..., None]
        den = eA * (1 - p[..., None]) + num
        frac = torch.where(den > 0, num / den, zero)
        pn = frac.sum(dim=-1) / n
        bad = ~((pn >= 0) & (pn <= 1))
        diff = torch.abs(torch.log1p(-pn) - torch.log1p(-p))
        # f32 saturation guard: p -> 1 makes log1p(-p) = -inf and the
        # difference nan; treat saturated lanes as converged (the f64
        # reference never quite reaches 1, cpp:764-786)
        conv = (diff < BRANCH_EPS) | ~torch.isfinite(diff) | (pn >= SAT_P)
        p = torch.where(done | bad, p, pn)
        done = done | conv | bad
    return torch.minimum(-torch.log1p(-p), max_len)


class OutOfWindowError(ValueError):
    """Raised when a window-resident placer receives reads whose
    placement window falls outside the staged site window; carries the
    offending batch row indices so the caller can reroute them."""

    def __init__(self, rows):
        self.rows = np.asarray(rows)
        super().__init__(
            f"{len(self.rows)} reads outside the resident site window")


def seed_pdist_bf16(seqs_w: torch.Tensor, q_valid: torch.Tensor,
                    n1h8: torch.Tensor, nv8: torch.Tensor) -> torch.Tensor:
    """Seed p-dist of [B, Ws] digital reads vs [N] node one-hot planes
    (reference SeqUtils::pDist, SeqUtils.cpp:31-47, dual-gap skip via
    validity planes).

    The node planes are stored as bf16 (0/1 exactly) and upcast to f32
    before the product: torch.matmul on bf16 operands returns bf16,
    which rounds counts above 256.  In f32 with TF32 off (resolve_device)
    the counts, sums of 0/1 products < 2^24, are exact.

    seqs_w [B, Ws] int8 (-2 pad / -1 gap / 0-3 base); q_valid [B, Ws]
    bool; n1h8 [N, Ws*4] and nv8 [N, Ws] bf16.  Returns [B, N] f32
    (nan where no site overlaps)."""
    B, Ws = seqs_w.shape
    f32 = torch.float32
    base4 = torch.arange(4, dtype=torch.int8, device=seqs_w.device)
    q1h = ((seqs_w[:, :, None] == base4) & q_valid[:, :, None]).to(f32)
    match = q1h.reshape(B, Ws * 4) @ n1h8.to(f32).t()
    both = q_valid.to(f32) @ nv8.to(f32).t()
    return torch.where(both > 0,
                       (both - match) / torch.clamp(both, min=1.0),
                       torch.full_like(both, math.nan))


def seed_pdist(seqs_w: torch.Tensor, q_valid: torch.Tensor, planes,
               n_nodes: int) -> torch.Tensor:
    """seed_pdist_bf16 against n_nodes nodes, one node block at a time:
    planes(n0, n1) gives the bf16 one-hot and validity planes of nodes
    [n0, n1), made only while their block's product runs, so the planes
    of a full-width window never exist whole.  The counts are integers
    below 2^24, exact in f32 in any summation order, so the result is
    that of one product over all nodes, bit for bit.  Returns [B, N]
    f32."""
    B, Ws = seqs_w.shape
    step = max(1, PDIST_CHUNK_BYTES // (PDIST_BYTES_PER_COL * max(Ws, 1)))
    if step >= n_nodes:
        return seed_pdist_bf16(seqs_w, q_valid, *planes(0, n_nodes))
    dist = torch.empty((B, n_nodes), dtype=torch.float32,
                       device=seqs_w.device)
    for n0 in range(0, n_nodes, step):
        n1 = min(n0 + step, n_nodes)
        dist[:, n0:n1] = seed_pdist_bf16(seqs_w, q_valid, *planes(n0, n1))
    return dist


def _wrap(idx: torch.Tensor, n: int) -> torch.Tensor:
    """numpy-style negative index (the root's parent -1 -> n-1)."""
    return torch.where(idx < 0, idx + n, idx)


def place_batch_device(dt: DeviceTree, seq_win: torch.Tensor,
                       starts: torch.Tensor, ends: torch.Tensor,
                       max_diff: float, max_height: float,
                       max_error: float, W: int, C: int, n_rates: int,
                       L: int, eig, height_prior: bool = False,
                       ml_only: bool = False, opt_k: int | None = None,
                       s0: int = 0, Ws: int | None = None,
                       ref_rank: bool = False, sep_kernel: bool = True,
                       fp_kernel: bool = True, est_kernel: bool = True,
                       node_lo: int | None = None) -> dict:
    """Full SEP placement of a read batch.

    seq_win: [B, W] int8 aligned digital reads, pre-sliced at the
        clamped window start min(start, s0+Ws-W).
    starts/ends: [B] int64 0-based inclusive CS windows.
    eig: (U, U^-1, lam) spectral model tensors (models.eig_tensors).
    (s0, Ws): the batch's union site window (DevicePlacer.union_window).
    sep_kernel, fp_kernel, est_kernel: which kernels run (see
    DevicePlacer); the defaults are the fused estimate + optimize path.
    node_lo: first global node id whose messages this call holds, for
        tree-sharded placement (parallel.sharded_place_batch_tree):
        dt.msg_up/msg_down are then a node slice [Nl, 4, Lw] and only
        nodes [node_lo, node_lo + Nl) are candidates; everything else
        in dt is whole and indexed by global ids.  The shards' grids
        merge on the host (pipeline.merge_mp_candidates).
    Returns a dict of [B, C'] candidate tensors and the [B, 12] summary.
    """
    from .cuda_place import (est, model_scalars, pad_msgs, pad_reads,
                             sep_optimize, take_padded)
    fused_est = sep_kernel and est_kernel
    dev = seq_win.device
    B = seq_win.shape[0]
    N = dt.seqs.shape[0]
    f32 = torch.float32
    if Ws is None:
        Ws = L
    starts = starts.to(torch.int64)
    ends = ends.to(torch.int64)
    starts_c = torch.clamp(starts, max=s0 + Ws - W)

    # ---- seed: p-dist of every read against every node, over the
    # batch's union site window [s0, s0+Ws) ------------------------------
    off = torch.clamp(starts_c - s0, 0, Ws - W)
    seqs_w = torch.full((B, Ws), -2, dtype=torch.int8, device=dev)
    seqs_w.scatter_(1, off[:, None] + torch.arange(W, device=dev),
                    seq_win.to(torch.int8))
    site_idx = torch.arange(Ws, device=dev)[None, :] + s0
    win = (site_idx >= starts[:, None]) & (site_idx <= ends[:, None])
    q_valid = (seqs_w >= 0) & win
    if dt.seq1h is not None:
        def planes(n0, n1):
            return (dt.seq1h[n0:n1].to(torch.bfloat16),
                    dt.nvalid[n0:n1].to(torch.bfloat16))
    else:
        lo = min(max(s0 - dt.msg_s0, 0), dt.seqs.shape[1] - Ws)
        base4 = torch.arange(4, dtype=torch.int8, device=dev)

        def planes(n0, n1):
            nseqs_w = dt.seqs[n0:n1, lo:lo + Ws]
            return ((nseqs_w[:, :, None] == base4).to(torch.bfloat16)
                    .reshape(n1 - n0, Ws * 4),
                    (nseqs_w >= 0).to(torch.bfloat16))
    dist = seed_pdist(seqs_w, q_valid, planes, N)          # [B, N]

    eligible = (dt.parent >= 0) & (dt.heights <= max_height)
    n_msg = dt.msg_up.shape[0]
    if node_lo is not None:
        node = torch.arange(N, device=dev)
        eligible = eligible & (node >= node_lo) & (node < node_lo + n_msg)
    dist_sort = torch.where(eligible[None, :] & ~torch.isnan(dist), dist,
                            torch.full_like(dist, INF))
    # C smallest, lower node id first on ties (jax.lax.top_k order)
    c_dist, cand = torch.sort(dist_sort, dim=1, stable=True)
    c_dist, cand = c_dist[:, :C].contiguous(), cand[:, :C].contiguous()
    C = cand.shape[1]           # the tree's N nodes where N < C
    best_dist = c_dist[:, :1]
    cand_ok = torch.isfinite(c_dist) & (c_dist - best_dist <= max_diff)

    # ---- candidate windows -----------------------------------------------
    Lw = dt.msg_up.shape[2]
    col = torch.clamp(starts_c - dt.msg_s0, 0, Lw - W)          # [B]
    cols = col[:, None] + torch.arange(W, device=dev)           # [B, W]
    k4 = torch.arange(4, device=dev)

    # rows of the candidates in the message tensors; a candidate
    # outside a node slice has an infinite distance (not cand_ok), and
    # its clamped row is never used
    row = cand if node_lo is None \
        else torch.clamp(cand - node_lo, 0, n_msg - 1)

    def gather(arr):
        return arr[row[:, :, None, None], k4[None, None, :, None],
                   cols[:, None, None, :]].to(f32)              # [B,C,4,W]

    U = gather(dt.msg_up)
    V = gather(dt.msg_down)
    obs = seq_win >= 0
    base1h = torch.nn.functional.one_hot(
        torch.clamp(seq_win.to(torch.int64), 0, 3), 4).permute(0, 2, 1)
    leaf = torch.where(obs[:, None, :],
                       torch.where(base1h > 0, 0.0, -INF).to(f32),
                       dt.log_pi[None, :, None].to(f32))        # [B, 4, W]
    Nl = leaf[:, None].expand(B, C, 4, W)
    wpos = torch.arange(W, device=dev)[None, :] + starts_c[:, None]
    site_ok = (wpos <= ends[:, None]) & (wpos >= starts[:, None])
    site_ok_c = site_ok[:, None, :].expand(B, C, W)

    # ---- estimate (closed form, no rate mixing) -------------------------
    w0 = dt.brlen[cand]
    p_dist_parent = torch.gather(dist, 1, _wrap(dt.parent[cand], N))
    ratio0 = c_dist / (c_dist + p_dist_parent)
    ratio0 = torch.where(torch.isnan(ratio0), 0.5, ratio0)
    wur0 = w0 * ratio0
    wvr0 = w0 - wur0
    ms = model_scalars(eig[0], eig[1], eig[2], dt.log_pi, dt.rates,
                       n_rates)
    pr_fn = make_pr_fn(eig)
    padded = None
    if fused_est:
        # the padded kernel-layout copies are built once and shared with
        # the optimize kernel below; the estimate takes the leaf message
        # and the mask once per read
        padded = pad_msgs(U, V, Nl, site_ok_c)
        del U, V
        est_loglik, wnr0 = est(padded[0], padded[1],
                               *pad_reads(leaf, site_ok), wur0.reshape(-1),
                               wvr0.reshape(-1), ms, C)
        est_loglik, wnr0 = est_loglik.reshape(B, C), wnr0.reshape(B, C)
    else:
        R0 = _dot_scaled(pr_fn(wur0), U) + _dot_scaled(pr_fn(wvr0), V)
        # unweighted initial pendant estimate (cpp:1018-1031)
        b1 = R0.argmax(dim=-2)
        b2 = Nl.argmax(dim=-2)
        wnr0 = (site_ok_c & (b1 != b2)).sum(-1) \
            / torch.clamp(site_ok_c.sum(-1), min=1)
        est_cols = _dot_scaled_vec(dt.log_pi,
                                   R0 + _dot_scaled(pr_fn(wnr0), Nl))
        del R0
        est_loglik = torch.where(site_ok_c, est_cols, 0.0).sum(-1)
    est_loglik = torch.where(cand_ok, est_loglik, -INF)

    # ---- filter (filterPlacements, HmmUFOtu_main.cpp:162-173) -----------
    best_est = est_loglik.max(dim=1, keepdim=True).values
    live = cand_ok & (best_est - est_loglik <= max_error)
    # optional compaction to the opt_k best candidates by estimate; the
    # default optimizes every survivor, like the reference
    opt_k = C if opt_k is None else min(opt_k, C)
    order = torch.sort(torch.where(live, est_loglik, -INF), dim=1,
                       descending=True, stable=True).indices[:, :opt_k]

    def take_c(x):
        idx = order.reshape(order.shape + (1,) * (x.dim() - 2))
        return torch.gather(x, 1, idx.expand(order.shape + x.shape[2:]))

    if padded is None:
        # the [B, C, 4, W] grids are consumed directly; the leaf message
        # and the site mask are the same for every candidate of a read,
        # so reordering candidates only narrows them
        U, V = take_c(U), take_c(V)
        Nl, site_ok_c = Nl[:, :opt_k], site_ok_c[:, :opt_k]
    cand, c_dist, w0 = take_c(cand), take_c(c_dist), take_c(w0)
    wur0, wvr0, wnr0 = take_c(wur0), take_c(wvr0), take_c(wnr0)
    est_loglik_k, live = take_c(est_loglik), take_c(live)

    # ---- joint 3-branch optimization ------------------------------------
    if sep_kernel:
        if padded is not None:
            padded_k = take_padded(padded, order, C)
            del padded
        else:
            padded_k = pad_msgs(U, V, Nl, site_ok_c)
            del U, V
        wur_f, wvr_f, wnr_f, ll = (
            x.reshape(B, opt_k) for x in sep_optimize(
                *padded_k, w0.reshape(-1), wur0.reshape(-1),
                wnr0.reshape(-1), live.reshape(-1), ms, n_rates)[:4])
        loglik = torch.where(live, ll, -INF)
        return _finish_placement(dt, cand, c_dist, live, w0, wur_f, wvr_f,
                                 wnr_f, loglik, est_loglik_k, max_height,
                                 height_prior, ml_only, ref_rank)

    # the outer loop in tensor ops over every lane of the grid; a done
    # lane keeps its values and the loop ends when all are done
    rates = dt.rates[:n_rates]
    wur, wvr, wnr = wur0, wvr0, wnr0
    done = ~live
    ones = torch.ones_like(wnr)
    for _ in range(MAX_ITER):
        if bool(done.all()):
            break
        Rn = _conv_mix(pr_fn, rates, [(U, wur), (V, wvr)])
        wnr_n = _fixed_point_branch(dt.log_pi, Rn, Nl, wnr, site_ok_c,
                                    ones, skip=done, use_kernel=fp_kernel)
        del Rn
        Ru = _conv_mix(pr_fn, rates, [(V, wvr), (Nl, wnr_n)])
        wur_n = _fixed_point_branch(dt.log_pi, Ru, U, wur, site_ok_c, w0,
                                    skip=done, use_kernel=fp_kernel)
        del Ru
        wvr_n = w0 - wur_n
        conv = ((wur_n - wur).abs() < BRANCH_EPS) \
            & ((wnr_n - wnr).abs() < BRANCH_EPS)
        bad = ~((wur_n >= 0) & (wur_n <= w0))
        wur = torch.where(done, wur, wur_n)
        wvr = torch.where(done, wvr, wvr_n)
        wnr = torch.where(done, wnr, wnr_n)
        done = done | conv | bad
    root_msg = _conv_mix(pr_fn, rates, [(U, wur), (V, wvr), (Nl, wnr)])
    cols = _dot_scaled_vec(dt.log_pi, root_msg)
    del root_msg
    loglik = torch.where(site_ok_c, cols, 0.0).sum(-1)
    loglik = torch.where(live, loglik, -INF)
    return _finish_placement(dt, cand, c_dist, live, w0, wur, wvr, wnr,
                             loglik, est_loglik_k, max_height,
                             height_prior, ml_only, ref_rank)


# front element of libstdc++ std::sort(rbegin, rend, always-false) on
# n all-equal elements, indexed by n; identity below the 16-element
# insertion-sort threshold
_INTROSORT_FRONT = (
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
    31, 17, 18, 18, 19, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 24,
    25, 25, 26, 26, 27, 27, 28, 28, 29, 29, 30, 30, 31, 31, 32, 32)


def _finish_placement(dt: DeviceTree, cand, c_dist, live, w0, wur_f,
                      wvr_f, wnr_f, loglik, est_loglik_k, max_height,
                      height_prior, ml_only, ref_rank: bool = False):
    """Q values + best-placement summary (calcQValues,
    HmmUFOtu_main.cpp:182-216, with taxon grouping via dense anno ids)."""
    N = dt.parent.shape[0]
    parent_c = dt.parent[cand]
    ratio_f = wur_f / w0
    height_f = dt.heights[cand] + wur_f
    a_is_c = (ratio_f <= 0.5) | (dt.heights[_wrap(parent_c, N)]
                                 > max_height)
    a_node = torch.where(a_is_c, cand, parent_c)
    anno_place = torch.where(a_is_c, wur_f + wnr_f, wvr_f + wnr_f)
    anno_total = anno_place + dt.anno_dist[_wrap(a_node, N)]
    if height_prior:
        # logPriorPr HEIGHT uses the placement distance only
        # (PhyloTreeUnrooted.cpp:1166-1177 + h:466-469)
        log_prior = -(anno_place - wnr_f + height_f)
    else:
        log_prior = torch.zeros_like(loglik)
    pp = torch.where(live, loglik + log_prior, -INF)
    m = pp.max(dim=1, keepdim=True).values
    wgt = torch.exp(pp - m)
    post = wgt / wgt.sum(dim=1, keepdim=True)
    q_place = torch.clamp(-10.0 * torch.log10(torch.clamp(1.0 - post,
                                                          min=0.0)),
                          max=250.0)
    tax = dt.anno_id[_wrap(a_node, N)]
    same = tax[:, :, None] == tax[:, None, :]
    pp_pair = torch.where(same, pp[:, None, :], -INF)
    lse_tax = torch.logsumexp(pp_pair, dim=-1)
    lse_all = torch.logsumexp(pp, dim=-1)[:, None]
    post_tax = torch.exp(lse_tax - lse_all)
    q_taxon = torch.clamp(-10.0 * torch.log10(torch.clamp(1.0 - post_tax,
                                                          min=0.0)),
                          max=250.0)
    if ref_rank:
        # reference-BINARY compatibility: every candidate's reported
        # loglik ties, and the unstable final sort brings the element at
        # estimate-rank _INTROSORT_FRONT[k] to the front
        # (PhyloTreeUnrooted.cpp:916-923, hmmufotu.cpp:730)
        est_live = torch.where(live, est_loglik_k, -INF)
        order = torch.argsort(-est_live, dim=1, stable=True)
        k = live.sum(dim=1)
        front = torch.as_tensor(_INTROSORT_FRONT, device=cand.device)
        pick_rank = front[torch.clamp(k, 0, len(_INTROSORT_FRONT) - 1)]
        best = torch.gather(order, 1, pick_rank[:, None])[:, 0]
    else:
        best = (torch.argmax(torch.where(live, loglik, -INF), dim=1)
                if ml_only else torch.argmax(pp, dim=1))

    def pick(x):
        return torch.gather(x, 1, best[:, None])[:, 0]

    f32 = lambda x: x.to(torch.float32)
    summary = torch.stack([
        f32(pick(cand)), f32(pick(parent_c)), f32(pick(a_node)),
        pick(ratio_f), pick(wnr_f), pick(loglik), pick(q_place),
        pick(q_taxon), pick(height_f), pick(anno_total), pick(w0),
        f32(live.any(dim=1)),
    ], dim=1)                                       # [B, 12]
    return {
        "cand": cand, "c_dist": c_dist, "live": live,
        "w0": w0, "ratio": ratio_f, "wnr": wnr_f,
        "loglik": loglik, "est_loglik": est_loglik_k,
        "height": height_f, "parent": parent_c,
        "q_place": q_place, "q_taxon": q_taxon,
        "summary": summary,
    }


def make_pr_fn(tensors):
    """P(t) from the spectral tensors (U, U^-1, lam) of a model (GTR.h
    :116-121 for GTR, models.eig_tensors for the others): returns a
    function of a branch-length tensor [...] -> [..., 4, 4]."""
    Um, U_1, lam = tensors

    def Pr(v):
        e = torch.exp(lam * v[..., None])
        prod = Um * e[..., None, :]
        return torch.clamp(prod @ U_1, min=0.0)

    return Pr


class DevicePlacer:
    """Batched placement of aligned reads on one device.

    device: "cuda" (default; raises without a card) or "cpu", where the
    kernels' plain PyTorch versions run."""

    def __init__(self, tree: PTUnrooted, window: int = 512,
                 max_nseed: int = 50, device="cuda", msg_dtype=None,
                 opt_k: int | None = None,
                 site_window: tuple[int, int] | None = None,
                 ref_rank: bool = False, sep_kernel: bool = True,
                 fp_kernel: bool = True, est_kernel: bool = True):
        """site_window=(s0, Ws): stage only CS columns [s0, s0+Ws) of the
        per-node tensors.  Every placed read's W-wide window must lie
        inside it; dispatch_win raises OutOfWindowError on violators.

        sep_kernel, fp_kernel, est_kernel (the reference package's
        sep_pallas, fp_pallas, est_kernel) choose the optimize path:
        sep_kernel=True runs the whole 3-branch optimization in kernel
        K3 (subsuming fp_kernel), fed by the estimate kernel K2 or, with
        est_kernel=False, by the tensor-op estimate; sep_kernel=False
        runs the outer loop in tensor ops, its inner fixed points in
        kernel K5 (fp_kernel=True) or in a tensor-op loop."""
        from .models import eig_tensors
        self.device = resolve_device(device)
        self.tree = tree
        self.W = min(window, tree.cs_len)
        self.C = max_nseed
        self.ref_rank = ref_rank
        self.opt_k = opt_k
        self.sep_kernel = sep_kernel
        self.fp_kernel = fp_kernel
        self.est_kernel = est_kernel
        if site_window is not None:
            s0, Ws = site_window
            Ws = min(Ws, tree.cs_len - s0)
            if Ws < self.W:
                raise ValueError(f"site_window width {Ws} < placement "
                                 f"window {self.W}")
            site_window = (s0, Ws)
        self.site_window = site_window
        self.dt = DeviceTree.from_tree(tree, self.device, msg_dtype,
                                       site_window)
        self.eig = tuple(torch.as_tensor(np.asarray(t, np.float32),
                                         device=self.device)
                         for t in eig_tensors(tree.model))
        self.n_rates = 1 if tree.dg is None else len(tree.dg.rates)
        self._replicas: dict = {}       # on_device's copies by device
        self._tree_shards: dict = {}    # parallel.tree_shards, by mesh

    @property
    def start_bound(self) -> int:
        """Largest valid clamped window start: csLen-W normally,
        (s0+Ws)-W when a site window is resident."""
        if self.site_window is not None:
            s0, Ws = self.site_window
            return s0 + Ws - self.W
        return self.tree.cs_len - self.W

    def union_window(self, starts) -> tuple[int, int]:
        """(s0, Ws) covering every read's site window in the batch, Ws
        bucketed to multiples of W (capped at csLen)."""
        if self.site_window is not None:
            return self.site_window
        L = self.tree.cs_len
        starts = np.asarray(starts, np.int64)
        sc = np.minimum(starts, L - self.W)
        lo = int(sc.min()) if len(starts) else 0
        span = (int(sc.max()) if len(starts) else 0) + self.W - lo
        Ws = min((span + self.W - 1) // self.W * self.W, L)
        s0 = max(0, min(lo, L - Ws))
        return s0, Ws

    def dispatch_win(self, seq_wins: np.ndarray, starts: np.ndarray,
                     ends: np.ndarray, max_diff: float = math.inf,
                     max_height: float = math.inf,
                     max_error: float = 20.0,
                     height_prior: bool = False,
                     ml_only: bool = False) -> dict:
        """Enqueue placement of pre-sliced [B, W] windows; returns the
        dict of device tensors without waiting for the device."""
        ends = np.minimum(ends, starts + self.W - 1)
        if self.site_window is not None:
            sc = np.minimum(np.asarray(starts, np.int64),
                            self.start_bound)
            bad = sc < self.site_window[0]
            if bad.any():
                raise OutOfWindowError(np.nonzero(bad)[0])
        s0, Ws = self.union_window(starts)
        to = lambda a, dt_: torch.as_tensor(np.asarray(a, dt_),
                                            device=self.device)
        return place_batch_device(
            self.dt, to(seq_wins, np.int8), to(starts, np.int64),
            to(ends, np.int64), max_diff, max_height, max_error, self.W,
            self.C, self.n_rates, self.tree.cs_len, self.eig,
            height_prior, ml_only, opt_k=self.opt_k, s0=s0, Ws=Ws,
            ref_rank=self.ref_rank, sep_kernel=self.sep_kernel,
            fp_kernel=self.fp_kernel, est_kernel=self.est_kernel)

    def place_batch(self, seqs: np.ndarray, starts: np.ndarray,
                    ends: np.ndarray, max_diff: float = math.inf,
                    max_height: float = math.inf,
                    max_error: float = 20.0,
                    height_prior: bool = False, ml_only: bool = False,
                    summary_only: bool = False) -> dict:
        """Place full-length [B, csLen] digital reads; clamps windows to
        the fixed width W.  Returns numpy arrays."""
        out = self.dispatch_win(self.windows(seqs, starts), starts, ends,
                                max_diff, max_height, max_error,
                                height_prior, ml_only)
        return _to_host(out, summary_only)

    def windows(self, seqs, starts) -> np.ndarray:
        """[B, W] placement windows of digital reads: full-length
        [B, csLen] reads sliced at min(start, start_bound); [B, W]
        windows as they are."""
        seqs = np.asarray(seqs, np.int8)
        if seqs.shape[1] == self.W:
            return seqs
        sc = np.minimum(np.asarray(starts, np.int64), self.start_bound)
        return seqs[np.arange(len(seqs))[:, None],
                    sc[:, None] + np.arange(self.W)]

    def place_batch_win(self, seq_wins: np.ndarray, starts: np.ndarray,
                        ends: np.ndarray, max_diff: float = math.inf,
                        max_height: float = math.inf,
                        max_error: float = 20.0,
                        height_prior: bool = False,
                        ml_only: bool = False,
                        summary_only: bool = False) -> dict:
        """place_batch on pre-sliced [B, W] windows (each starting at
        min(start, start_bound)), so only W bytes a read are uploaded.
        Returns numpy arrays."""
        out = self.dispatch_win(seq_wins, starts, ends, max_diff,
                                max_height, max_error, height_prior,
                                ml_only)
        return _to_host(out, summary_only)

    def on_device(self, device) -> tuple[DeviceTree, tuple]:
        """(DeviceTree, eig tensors) on `device`: the placer's own where
        it is the placer's device, else copies made once and kept."""
        dev = _indexed(torch.device(device))
        if dev == _indexed(self.device):
            return self.dt, self.eig
        if dev not in self._replicas:
            self._replicas[dev] = (moved(self.dt, dev),
                                   moved(self.eig, dev))
        return self._replicas[dev]


def _indexed(dev: torch.device) -> torch.device:
    """`dev` with its card's index ("cuda" names the current card)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def moved(tensors, device):
    """A tuple or NamedTuple of tensors (other fields kept) on `device`."""
    out = [x.to(device) if torch.is_tensor(x) else x for x in tensors]
    return type(tensors)(*out) if hasattr(tensors, "_fields") \
        else tuple(out)


def _to_host(out: dict, summary_only: bool) -> dict:
    if summary_only:
        return {"summary": out["summary"].cpu().numpy()}
    return {k: v.cpu().numpy() for k, v in out.items()}
