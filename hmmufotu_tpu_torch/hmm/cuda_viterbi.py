"""Banded Viterbi DP on the device: the CUDA kernel of csrc/viterbi.cu in
its two modes, K1 (traceback in the kernel) and K4 (choice planes
written to device memory), each beside its plain PyTorch version.

Counterpart of hmmufotu_tpu/hmm/pallas_viterbi.py.  This module stages
the cost rows, builds the per-read metadata, routes K1's reads between a
narrow band-relative launch and a full-width launch (viterbi_traced_split,
the host routing of viterbi_pallas_traced_split) and decodes the results.

K1 output contract (the kernel and viterbi_traced_plain): one
[B, 8 + TPS] int32 "comb" — cols 0:8 are the f32 bits of (score, best_i,
best_j, aln_start, aln_end, aln_from, aln_to, 0), cols 8: the
nibble-packed reverse state strings (decode with unpack_emits).

K4 output contract (the kernel and viterbi_planes_plain, counterpart of
viterbi_pallas): (score [B] f32, min_i [B] int32, min_j [B] int32,
packed [n_rows/8, B, KPF] int32) — the 4-bit choices of DP row g*8+r in
nibble 7-r of plane g, at full profile width (decode with
unpack_nibble_choices, or walk with viterbi.traceback_packed on the host
and traceback_device_packed on the device).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _cuda
from .viterbi import (MAX_REGIONS, REGION_WIDTH, shift_lanes as shift,
                      walk_choices)

PACK_ROWS = 8                        # DP rows packed per int32 plane
PAD_NIBBLE = 5                       # traceback pad state
PAD_WORD = 0x55555555                # 8 pad nibbles per int32
DEFAULT_BAND_LANES = 384
BIG = 1 << 30
# shared memory a block may use (H100: 227 KB); wider choice planes go
# to a device-memory scratch buffer
SMEM_LIMIT = 227 * 1024


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def stage_costs(dh):
    """Cost rows in kernel layout: tc [16, KPF] (0 TMM_sh, 1 TIM_sh,
    2 TDM_sh, 3 TMD_sh, 4 TDD_sh, 5 TMI, 6 TII, 7 entry, 8 exit; the _sh
    rows shifted one lane right), em [8, KPF] (4 match + 4 insert
    emission rows), scal [8] (t_NN, t_NB, t_CC, t_EC, TIM[K], 0, 0, 0).
    Lanes past K+1 are +inf."""
    K = dh.K
    KPF = _round_up(K + 2, 128)
    dev = dh.EM.device
    f32 = torch.float32
    inf = float("inf")

    def padded(v):
        out = torch.full((KPF,), inf, dtype=f32, device=dev)
        out[: v.shape[0]] = v.to(f32)
        return out

    def shift1(v):
        return torch.cat([torch.full((1,), inf, dtype=f32, device=dev),
                          v[:-1].to(f32)])

    zero = torch.zeros(KPF, dtype=f32, device=dev)
    tc = torch.stack([
        padded(shift1(dh.TMM)), padded(shift1(dh.TIM)),
        padded(shift1(dh.TDM)), padded(shift1(dh.TMD)),
        padded(shift1(dh.TDD)), padded(dh.TMI), padded(dh.TII),
        padded(dh.entry), padded(dh.exit)] + [zero] * 7)
    em = torch.stack([padded(dh.EM[b]) for b in range(4)]
                     + [padded(dh.EI[b]) for b in range(4)])
    z = torch.zeros((), dtype=f32, device=dev)
    scal = torch.stack([dh.t_NN.to(f32), dh.t_NB.to(f32),
                        dh.t_CC.to(f32), dh.t_EC.to(f32),
                        dh.TIM[K].to(f32), z, z, z])
    return tc.contiguous(), em.contiguous(), scal.contiguous()


def launch_shape(K: int, n_rows: int, KB: int | None):
    """(KP lanes, max_steps, TPS) of a launch, as the TPU kernel sizes
    them: the traceback path is <= n_rows + (j travel) + 2 states, 8 per
    int32 word, padded to 128 words."""
    KPF = _round_up(K + 2, 128)
    banded = KB is not None
    KP = KPF if KB is None else min(KB, KPF)
    max_steps = _round_up(n_rows + min(K, KP if banded else K) + 2, 8)
    TPS = _round_up(max_steps // 8, 128)
    return KP, TPS * 8, TPS


def make_meta(lengths: np.ndarray, regions: np.ndarray) -> np.ndarray:
    """[B, 128] int32: col 0 read length, cols 8.. the region scalars."""
    B = len(lengths)
    meta = np.zeros((B, 128), np.int32)
    meta[:, 0] = lengths
    meta[:, 8:8 + MAX_REGIONS * REGION_WIDTH] = regions.reshape(B, -1)
    return meta


def _dp_rows_plain(tc, em, scal, codes, meta, jb, n_rows: int, K: int,
                   KP: int, n_regions: int, dchain: int):
    """The row recurrence shared by the plain versions of K1 and K4,
    batched over reads: the same cell arithmetic, D-chain doubling scan
    and running best as csrc/viterbi.cu and the Pallas _viterbi_kernel.

    Returns (best [B] f32, best_i [B] int64, best_j [B] int64,
    choices [n_rows, B, KP] uint8)."""
    dev = codes.device
    B = codes.shape[0]
    KPF = tc.shape[1]
    f32 = torch.float32
    INF = float("inf")
    lanes = torch.arange(KP, device=dev)
    jb64 = jb.to(torch.int64)
    jabs = lanes[None, :] + jb64[:, None]                # [B, KP]
    cidx = jabs % KPF
    rows = [tc[q][cidx] for q in range(9)]
    TMM_sh, TIM_sh, TDM_sh, TMD_sh, TDD_sh, TMI, TII, entry_c, exit_c = \
        rows
    EM = [em[b][cidx] for b in range(4)]
    EI = [em[b + 4][cidx] for b in range(4)]
    t_NN, t_NB, t_CC, t_EC, tIMK = (scal[q] for q in range(5))

    lane_valid = jabs <= K
    d_invalid = (jabs <= 1) | (jabs >= K)
    is_lane_k = jabs == K
    lengths = meta[:, 0].to(torch.int64)
    reg = meta[:, 8:8 + MAX_REGIONS * REGION_WIDTH].to(torch.int64) \
        .reshape(B, MAX_REGIONS, REGION_WIDTH)[:, :n_regions]
    j_lo, j_hi, i_lo, i_hi, ent, diag, lo_d, hi_d = \
        (reg[:, :, c] for c in range(REGION_WIDTH))
    j_lo1 = j_lo.clamp(min=1)
    j_hi1 = j_hi.clamp(max=K)
    isdiag = diag != 0
    ent1 = ent == 1

    def masks_for_row(i):
        ci = i - i_lo
        lo = torch.where(isdiag, torch.maximum(j_lo1, j_lo + ci - hi_d),
                         j_lo1)
        hi = torch.where(isdiag, torch.minimum(j_hi1, j_lo + ci - lo_d),
                         j_hi1)
        lo = torch.where((i >= i_lo) & (i <= i_hi), lo, BIG)
        cov = (jabs[:, None, :] >= lo[:, :, None]) \
            & (jabs[:, None, :] <= hi[:, :, None])       # [B, nr, KP]
        return cov.any(1), (cov & ent1[:, :, None]).any(1)

    Mp = torch.full((B, KP), INF, dtype=f32, device=dev)
    Ip = Mp.clone()
    Dp = Mp.clone()
    best = torch.full((B,), INF, dtype=f32, device=dev)
    best_i = torch.zeros(B, dtype=torch.int64, device=dev)
    best_j = torch.full((B,), BIG, dtype=torch.int64, device=dev)
    choices = torch.empty((n_rows, B, KP), dtype=torch.uint8, device=dev)
    codes64 = codes.to(torch.int64)
    inf_t = torch.tensor(INF, dtype=f32, device=dev)
    for i in range(1, n_rows + 1):
        bsel = codes64[:, i - 1:i]                       # [B, 1]
        em_i = EM[0].clone()
        ei_i = EI[0].clone()
        for b in range(1, 4):
            pick = bsel == b
            em_i = torch.where(pick, EM[b], em_i)
            ei_i = torch.where(pick, EI[b], ei_i)
        col0 = (torch.zeros((), dtype=f32, device=dev) if i == 1
                else t_NN * float(i - 1)) + t_NB
        allowed, entry_ok = masks_for_row(i)

        optB = torch.where(entry_ok, col0 + entry_c, inf_t)
        optM = shift(Mp, 1, INF) + TMM_sh
        optI = shift(Ip, 1, INF) + TIM_sh
        optD = shift(Dp, 1, INF) + TDM_sh
        mn = torch.minimum(torch.minimum(optB, optM),
                           torch.minimum(optI, optD))
        Mn = em_i + mn
        choiceM = torch.where(optB <= mn, 0, torch.where(
            optM <= mn, 1, torch.where(optI <= mn, 2, 3)))
        c1 = torch.where(optB <= optI, 0, 2)
        choiceM = torch.where(jabs == 1, c1, choiceM)
        Mn = torch.where(allowed, Mn, inf_t)
        Mn = torch.where(jabs == 0, col0, Mn)

        iM = Mp + TMI
        iI = Ip + TII
        In = ei_i + torch.minimum(iM, iI)
        choiceI = (iM > iI).to(torch.int64)
        In = torch.where(allowed, In, inf_t)
        In = torch.where(jabs == 0, col0, In)
        ci0 = (Mn[:, 0:1] + TMI[:, 0:1] > Ip[:, 0:1] + TII[:, 0:1]) \
            .to(torch.int64)
        choiceI = torch.where(jabs == 0, ci0, choiceI)

        Mn_sh = shift(Mn, 1, INF)
        dmask = ~d_invalid & allowed
        fresh = Mn_sh + TMD_sh
        a = torch.where(dmask, fresh, inf_t)
        c = torch.where(dmask, TDD_sh, inf_t)
        s = 1
        while s < min(dchain, KP):
            a_sh = shift(a, s, INF)
            c_sh = shift(c, s, 0.0)
            a = torch.minimum(a_sh + c, a)
            c = c_sh + c
            s *= 2
        Dn = torch.where(d_invalid, inf_t, a)
        choiceD = (fresh > shift(Dn, 1, INF) + TDD_sh).to(torch.int64)

        live = i <= lengths                              # [B]
        rem = (lengths - i).to(f32)
        c_loops = torch.where(i < lengths, t_CC * rem,
                              torch.zeros((), dtype=f32, device=dev))
        s_m = Mn + exit_c + t_EC + c_loops[:, None]
        s_m = torch.where(lane_valid & live[:, None], s_m, inf_t)
        in_k = torch.where(is_lane_k, In, inf_t).min(1).values
        s_i = in_k + tIMK + t_EC + c_loops
        s_i = torch.where(live, s_i, inf_t)
        row_min_m = s_m.min(1).values
        ismin = s_m == row_min_m[:, None]
        row_j_m = torch.where(ismin, jabs, BIG).min(1).values
        row_min = torch.minimum(row_min_m, s_i)
        row_j = torch.where(row_min_m <= s_i, row_j_m, K + 1)
        upd = (row_min < best) | ((row_min == best) & (row_j < best_j))
        best = torch.where(upd, row_min, best)
        best_i = torch.where(upd, i, best_i)
        best_j = torch.where(upd, row_j, best_j)

        choices[i - 1] = (choiceM | (choiceI << 2) | (choiceD << 3)) \
            .to(torch.uint8)
        Mp, Ip, Dp = Mn, In, Dn
    return best, best_i, best_j, choices


def viterbi_traced_plain(tc, em, scal, codes, meta, jb, n_rows: int,
                         K: int, KP: int, max_steps: int,
                         n_regions: int = MAX_REGIONS,
                         dchain: int = BIG) -> torch.Tensor:
    """Plain PyTorch version of K1, batched over reads: the row
    recurrence of _dp_rows_plain, then the traceback.

    codes [B, n_rows] int32 (0..3), meta [B, 128] int32, jb [B] int32
    band origin (absolute profile position of lane 0).
    Returns comb [B, 8 + max_steps // 8] int32."""
    best, best_i, best_j, choices = _dp_rows_plain(
        tc, em, scal, codes, meta, jb, n_rows, K, KP, n_regions, dchain)
    dev = codes.device
    B = codes.shape[0]
    f32 = torch.float32
    TPS = max_steps // 8
    jb64 = jb.to(torch.int64)
    # ---- traceback (reference buildViterbiTrace,
    # BandedHMMP7.cpp:943-1006) over band-relative lanes
    ar = torch.arange(B, device=dev)
    s = torch.where(best_j <= K, 1, 2)
    j0 = torch.clamp(best_j, max=K)
    j = j0 - jb64
    i = best_i.clone()
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    emits = torch.full((B, max_steps), PAD_NIBBLE, dtype=torch.int64,
                       device=dev)
    for t in range(max_steps):
        live = ~done & (i >= 1) & (j >= 0)
        if not bool(live.any()):
            break
        emits[:, t] = torch.where(live, s, PAD_NIBBLE)
        ch = choices[(i - 1).clamp(0, n_rows - 1), ar,
                     j.clamp(0, KP - 1)].to(torch.int64)
        cm = ch & 3
        ci = (ch >> 2) & 1
        cd = (ch >> 3) & 1
        is_m, is_i, is_d = s == 1, s == 2, s == 3
        nxt_i = torch.where(j + jb64 > 0, torch.where(ci == 0, 1, 2),
                            torch.where(ci == 0, 0, 2))
        nxt_d = torch.where(cd == 0, 1, 3)
        s_n = torch.where(is_m, cm, torch.where(
            is_i, nxt_i, torch.where(is_d, nxt_d, s)))
        i_n = i - (is_m | is_i).to(torch.int64)
        j_n = j - (is_m | is_d).to(torch.int64)
        done = done | (live & (s == 0)) | ~live
        s = torch.where(live, s_n, s)
        i = torch.where(live, i_n, i)
        j = torch.where(live, j_n, j)

    shifts = torch.tensor([4 * (7 - k) for k in range(8)], device=dev)
    words = (emits.reshape(B, TPS, 8) << shifts).sum(-1).to(torch.int32)
    sb = torch.stack([
        best, best_i.to(f32), best_j.to(f32), (j + jb64 + 1).to(f32),
        j0.to(f32), (i + 1).to(f32), best_i.to(f32),
        torch.zeros(B, dtype=f32, device=dev)], dim=1)
    return torch.cat([sb.view(torch.int32), words], dim=1)


def _lanes_per_thread(KP: int) -> tuple[int, int]:
    """(lanes a thread, threads) of a launch over KP lanes, among the
    shapes csrc/viterbi.cu is built for: 1 lane up to 512 threads, 2 up
    to 768 (the full profile width of a 16S model), 4 up to 512, 8 up to
    1,024."""
    for lpt, most in ((1, 512), (2, 768), (4, 512), (8, 1024)):
        threads = _round_up(-(-KP // lpt), 32)
        if threads <= most:
            return lpt, threads
    raise ValueError(f"band of {KP} lanes exceeds the kernel's "
                     "8 lanes x 1024 threads")


def viterbi_traced_cuda(tc, em, scal, codes, meta, jb, n_rows: int,
                        K: int, KP: int, max_steps: int,
                        n_regions: int = MAX_REGIONS,
                        dchain: int = BIG) -> torch.Tensor:
    """Launch K1 (csrc/viterbi.cu) on CUDA tensors; same arguments and
    result as viterbi_traced_plain."""
    for t, dt, nd, name in ((tc, torch.float32, 2, "tc"),
                            (em, torch.float32, 2, "em"),
                            (scal, torch.float32, 1, "scal"),
                            (codes, torch.int32, 2, "codes"),
                            (meta, torch.int32, 2, "meta"),
                            (jb, torch.int32, 1, "jb")):
        _cuda.require(t, dt, nd, name)
    B = codes.shape[0]
    KPF = tc.shape[1]
    if tc.shape[0] != 16 or em.shape != (8, KPF) or scal.shape[0] != 8:
        raise ValueError("cost rows must be tc [16, KPF], em [8, KPF], "
                         "scal [8]")
    if codes.shape[1] != n_rows or meta.shape != (B, 128) \
            or jb.shape != (B,):
        raise ValueError("codes/meta/jb shapes disagree with the batch")
    if n_rows % PACK_ROWS or max_steps % 8 or KP > KPF:
        raise ValueError("n_rows and max_steps must be multiples of 8 "
                         "and KP <= KPF")
    TPS = max_steps // 8
    lpt, threads = _lanes_per_thread(KP)
    G = n_rows // PACK_ROWS
    planes_bytes = G * KP * 4
    in_smem = 5 * KP * 4 + planes_bytes <= SMEM_LIMIT - 4096
    if 5 * KP * 4 > SMEM_LIMIT - 4096:
        raise ValueError(f"band of {KP} lanes exceeds shared memory")
    dev = codes.device
    comb = torch.empty((B, 8 + TPS), dtype=torch.int32, device=dev)
    scratch = (torch.empty(1, dtype=torch.int32, device=dev) if in_smem
               else torch.empty((max(B, 1), G, KP), dtype=torch.int32,
                                device=dev))
    lib = _cuda.load_library("viterbi")
    fn = lib.hm_viterbi_traced
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12 \
        + [ctypes.c_void_p]
    _cuda.launch("viterbi_traced", fn, codes,
                 tc.data_ptr(), em.data_ptr(), scal.data_ptr(),
                 codes.data_ptr(), meta.data_ptr(), jb.data_ptr(),
                 comb.data_ptr(), scratch.data_ptr(), B, n_rows, K, KPF, KP,
                 max_steps, TPS, n_regions, dchain, lpt, threads,
                 int(in_smem))
    if B:
        viterbi_traced_cuda.launches.add()
    return comb


viterbi_traced_cuda.launches = _cuda.LaunchCounter()


def viterbi_traced(tc, em, scal, codes, meta, jb, n_rows: int, K: int,
                   KP: int, max_steps: int, n_regions: int = MAX_REGIONS,
                   dchain: int = BIG) -> torch.Tensor:
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    fn = (viterbi_traced_cuda if codes.device.type == "cuda"
          else viterbi_traced_plain)
    return fn(tc, em, scal, codes, meta, jb, n_rows, K, KP, max_steps,
              n_regions, dchain)


def viterbi_planes_plain(tc, em, scal, codes, meta, n_rows: int, K: int):
    """Plain PyTorch version of K4: the full-width DP (no band origin,
    all KPF lanes, MAX_REGIONS slots, unbounded D chain, as
    viterbi_pallas runs it) with the choices nibble-packed 8 rows per
    int32 plane.

    codes [B, n_rows] int32 (0..3), meta [B, 128] int32.
    Returns (score [B] f32, min_i [B] int32, min_j [B] int32,
    packed [n_rows/8, B, KPF] int32)."""
    if n_rows % PACK_ROWS:
        raise ValueError(f"n_rows {n_rows} must be a multiple of "
                         f"{PACK_ROWS}")
    B = codes.shape[0]
    KPF = tc.shape[1]
    jb = torch.zeros(B, dtype=torch.int32, device=codes.device)
    best, best_i, best_j, choices = _dp_rows_plain(
        tc, em, scal, codes, meta, jb, n_rows, K, KPF, MAX_REGIONS, BIG)
    ch = choices.reshape(n_rows // PACK_ROWS, PACK_ROWS, B, KPF)
    word = torch.zeros(ch[:, 0].shape, dtype=torch.int64,
                       device=codes.device)
    for r in range(PACK_ROWS):
        word |= ch[:, r].to(torch.int64) << (4 * (PACK_ROWS - 1 - r))
    # the top nibble reaches bit 31: wrap into int32 as the kernel's
    # shifts do
    packed = torch.where(word >= 1 << 31, word - (1 << 32), word) \
        .to(torch.int32)
    return (best, best_i.to(torch.int32), best_j.to(torch.int32), packed)


def viterbi_planes_cuda(tc, em, scal, codes, meta, n_rows: int, K: int):
    """Launch K4 (csrc/viterbi.cu hm_viterbi_planes) on CUDA tensors;
    same arguments and result as viterbi_planes_plain.  One block per
    read, so any batch size launches as it is; the planes are a fresh
    tensor of the caching allocator, which hands a batch shape's freed
    block back to the next batch."""
    for t, dt, nd, name in ((tc, torch.float32, 2, "tc"),
                            (em, torch.float32, 2, "em"),
                            (scal, torch.float32, 1, "scal"),
                            (codes, torch.int32, 2, "codes"),
                            (meta, torch.int32, 2, "meta")):
        _cuda.require(t, dt, nd, name)
    B = codes.shape[0]
    KPF = tc.shape[1]
    if tc.shape[0] != 16 or em.shape != (8, KPF) or scal.shape[0] != 8:
        raise ValueError("cost rows must be tc [16, KPF], em [8, KPF], "
                         "scal [8]")
    if codes.shape[1] != n_rows or meta.shape != (B, 128):
        raise ValueError("codes/meta shapes disagree with the batch")
    if n_rows % PACK_ROWS:
        raise ValueError(f"n_rows {n_rows} must be a multiple of "
                         f"{PACK_ROWS}")
    if K + 2 > KPF:
        raise ValueError(f"profile of {K} positions exceeds the {KPF} "
                         "staged lanes")
    lpt, threads = _lanes_per_thread(KPF)
    if 5 * KPF * 4 > SMEM_LIMIT - 4096:
        raise ValueError(f"profile of {KPF} lanes exceeds shared memory")
    dev = codes.device
    G = n_rows // PACK_ROWS
    packed = torch.empty((G, B, KPF), dtype=torch.int32, device=dev)
    sb = torch.empty((B, 8), dtype=torch.int32, device=dev)
    fn = _cuda.load_library("viterbi").hm_viterbi_planes
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    _cuda.launch("viterbi_planes", fn, codes,
                 tc.data_ptr(), em.data_ptr(), scal.data_ptr(),
                 codes.data_ptr(), meta.data_ptr(), sb.data_ptr(),
                 packed.data_ptr(), B, n_rows, K, KPF, lpt, threads)
    if B:
        viterbi_planes_cuda.launches.add()
    sb_f = sb.view(torch.float32)
    return (sb_f[:, 0], sb_f[:, 1].to(torch.int32),
            sb_f[:, 2].to(torch.int32), packed)


viterbi_planes_cuda.launches = _cuda.LaunchCounter()


def viterbi_planes(tc, em, scal, codes, meta, n_rows: int, K: int):
    """K4 on CUDA tensors, its plain version on CPU tensors."""
    fn = (viterbi_planes_cuda if codes.device.type == "cuda"
          else viterbi_planes_plain)
    return fn(tc, em, scal, codes, meta, n_rows, K)


def _dchain_bound(reg: np.ndarray, used: np.ndarray, K: int) -> int:
    """Static power-of-two bound on the longest run of consecutive
    allowed D cells in any DP row: the sum of per-region max widths
    (diagonal regions capped by their band thickness), bucketed to
    {64, 256, 1024, unbounded}."""
    if not used.any():
        return 64
    jl = np.maximum(reg[:, :, 0], 1)
    jh = np.minimum(reg[:, :, 1], K)
    # a region that clips to an empty interval contributes 0
    w = np.where(used, np.maximum(jh - jl + 1, 0), 0)
    isd = (reg[:, :, 5] != 0) & used
    wd = np.maximum(reg[:, :, 7] - reg[:, :, 6] + 1, 0)
    w = np.where(isd, np.minimum(w, wd), w)
    m = int(w.sum(axis=1).max())
    for b in (64, 256, 1024):
        if m <= b:
            return b
    return BIG


def _region_bucket(reg_used: np.ndarray) -> int:
    """Region slots a batch needs, bucketed to {3, MAX_REGIONS} (seeded
    reads use 3 slots, 2 more per extra seed chain)."""
    if not reg_used.size:
        return MAX_REGIONS
    hi = int(np.max(np.where(reg_used,
                             np.arange(reg_used.shape[1])[None, :],
                             -1))) + 1
    return 3 if hi <= 3 else MAX_REGIONS


def _run(staged, K, codes, lengths, regions, jb, n_rows, KB, n_regions,
         dchain):
    tc, em, scal = staged
    dev = tc.device
    KP, max_steps, _ = launch_shape(K, n_rows, KB)
    meta = make_meta(lengths, regions)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)) \
        .to(dev)
    return viterbi_traced(tc, em, scal, to(np.clip(codes, 0, 3)),
                          to(meta), to(jb), n_rows, K, KP, max_steps,
                          n_regions, dchain)


def viterbi_traced_split(staged, K: int, codes: np.ndarray,
                         lengths: np.ndarray, regions: np.ndarray,
                         n_rows: int, KB: int = DEFAULT_BAND_LANES
                         ) -> torch.Tensor:
    """Traced Viterbi with narrow/wide band routing (the host routing of
    the TPU's viterbi_pallas_traced_split): reads whose region span fits
    a KB-lane window run in the band-relative launch, the rest (unseeded
    full-DP reads, extreme bands) in a full-width launch whose rows are
    merged back.  A batch that is mostly wide runs full width.

    staged = stage_costs(dh); codes/lengths/regions numpy.  Returns the
    comb [B, 8 + TPS] int32 on the staged device."""
    KPF = _round_up(K + 2, 128)
    reg = np.asarray(regions)
    B = reg.shape[0]
    used = reg[:, :, 1] > 0
    zeros = np.zeros(B, np.int64)
    if KB >= KPF:
        return _run(staged, K, codes, lengths, reg, zeros, n_rows, None,
                    _region_bucket(used), _dchain_bound(reg, used, K))
    jlo = np.where(used, np.maximum(reg[:, :, 0], 1),
                   np.int64(1) << 40).min(axis=1)
    jhi = np.where(used, np.minimum(reg[:, :, 1], K), 0).max(axis=1)
    jb = np.maximum(jlo - 1, 0).astype(np.int64)
    none_used = ~used.any(axis=1)          # padded rows
    jb[none_used] = 0
    wide = (jhi - jb + 1 > KB) & ~none_used
    jb[wide] = 0                           # their narrow rows are discarded
    n_wide = int(wide.sum())
    nr_all = _region_bucket(used)
    if n_wide == 0:
        return _run(staged, K, codes, lengths, reg, jb, n_rows, KB,
                    nr_all, _dchain_bound(reg, used, K))
    if 2 * n_wide >= B:
        return _run(staged, K, codes, lengths, reg, zeros, n_rows, None,
                    nr_all, _dchain_bound(reg, used, K))
    widx = np.nonzero(wide)[0]
    narrow = ~wide & ~none_used
    comb_n = _run(staged, K, codes, lengths, reg, jb, n_rows, KB, nr_all,
                  _dchain_bound(reg[narrow], used[narrow], K))
    comb_w = _run(staged, K, codes[widx], lengths[widx], reg[widx],
                  zeros[widx], n_rows, None, _region_bucket(used[widx]),
                  _dchain_bound(reg[widx], used[widx], K))
    Tn, Tw = comb_n.shape[1], comb_w.shape[1]
    if Tw > Tn:
        pad = torch.full((B, Tw - Tn), PAD_WORD, dtype=torch.int32,
                         device=comb_n.device)
        comb_n = torch.cat([comb_n, pad], dim=1)
    comb_n[torch.from_numpy(widx).to(comb_n.device)] = comb_w
    return comb_n


def unpack_emits(emits: np.ndarray) -> np.ndarray:
    """Decode [B, TPS] int32 nibble-packed traceback words to
    [B, TPS*8] uint8 state codes (step t = word t>>3, nibble 7-(t&7);
    5 = pad)."""
    B, TPS = emits.shape
    out = np.empty((B, TPS, 8), dtype=np.uint8)
    for k in range(8):
        out[:, :, k] = ((emits >> (4 * (7 - k))) & 0xF).astype(np.uint8)
    return out.reshape(B, TPS * 8)


def unpack_nibble_choices(packed: np.ndarray, n_rows: int,
                          lanes: int) -> np.ndarray:
    """Decode [n_rows/8, B, KP] int32 nibble planes to
    [n_rows, B, lanes] uint8 choice planes (row g*8+r lives in nibble
    7-r of plane g)."""
    G, B, KP = packed.shape
    out = np.empty((G, PACK_ROWS, B, KP), dtype=np.uint8)
    for r in range(PACK_ROWS):
        out[:, r] = ((packed >> (4 * (PACK_ROWS - 1 - r))) & 0xF) \
            .astype(np.uint8)
    return out.reshape(G * PACK_ROWS, B, KP)[:n_rows, :, :lanes]


def traceback_device_packed(packed: torch.Tensor, min_i: torch.Tensor,
                            min_j: torch.Tensor, K: int, max_steps: int):
    """Batched traceback walking K4's nibble-packed [G, B, KP] planes on
    their device: only the [B, max_steps] state strings go to the host
    (same contract as viterbi.traceback_device)."""
    G, B, KP = packed.shape
    ar = torch.arange(B, device=packed.device)

    def fetch(i, j):
        word = packed[((i - 1) >> 3).clamp(0, G - 1), ar,
                      j.clamp(0, KP - 1)].to(torch.int64)
        return (word >> (4 * (7 - ((i - 1) & 7)))) & 15

    return walk_choices(fetch, B, min_i, min_j, K, max_steps)
