"""Batched banded Viterbi alignment on the device (PyTorch).

Counterpart of hmmufotu_tpu/hmm/viterbi.py (reference:
src/BandedHMMP7.cpp:748-780 full DP, :782-892 banded DP, :943-1006
traceback).  ViterbiAligner runs a read batch in one of four modes:

  kernel   traceback  DP                              what reaches the host
  "cuda"   "device"   K1, traceback in the kernel     [B, 8 + TPS] int32 comb
  "cuda"   "host"     K4, choice planes to memory     [n_rows/8, B, KPF] planes
  "scan"   "host"     viterbi_scan (torch row loop)   [n_rows, B, K+1] choices
  "scan"   "device"   viterbi_scan + traceback_device [B, steps] state codes

K1 and K4 are the two modes of one CUDA kernel (hmm/cuda_viterbi.py,
csrc/viterbi.cu); viterbi_scan is the row recurrence in plain tensor
ops.  The host builds the alignment strings in every mode.  Reads whose
banded DP finds no finite path are re-run as full DP (reference
HmmUFOtu_main.cpp:89-96).

Banding is expressed as per-read region scalars (banded_regions); cells
outside every region are pinned to +inf, so the banded and the full DP
are the same recurrence.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from .._cuda import resolve_device
from ..utils import trace
from .profile import (HmmAlignment, K_MIN_GAP_FRAC, ProfileHMM,
                      ViterbiAlignPath, build_global_align,
                      build_global_align_path)

INF = float("inf")
PAD_STATE = 5                        # traceback pad state code


class _Timing(dict):
    """Seconds of the aligner's stages by key (the reference package's
    TIMING), filled from the tracer's spans of those names while it is
    on (utils.trace, HMMUFOTU_TIMING=1): dp_dispatch, dp, scalars_dl, and
    trace_dl + host_build (K1) or choices_dl + unpack + host_trace (K4).
    clear() also starts a new timing: it turns the tracer on or off as
    HMMUFOTU_TIMING then reads."""

    def clear(self):
        super().clear()
        trace.enable()


TIMING = _Timing()


def _stage(key):
    """The aligner's stage `key` as a tracer span that adds into TIMING."""
    return trace.span(key, sink=TIMING)


def _done_event(device):
    """A CUDA event recorded after the work just enqueued, while the
    tracer is on (None otherwise, and on the CPU)."""
    if not trace.ON or device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _wait_if_timing(ev):
    """Wait for the event of _done_event: the DP's own result, so that
    the "dp" stage parts the wait for the kernel from the download
    ("scalars_dl") without waiting for the work queued after it."""
    if ev is not None:
        ev.synchronize()

# region tuple layout: (j_lo, j_hi, i_lo, i_hi, entry_ok, diag, lo_d, hi_d)
REGION_WIDTH = 8
MAX_REGIONS = 5


class DeviceHMM(NamedTuple):
    """Cost arrays of a ProfileHMM as f32 tensors on one device."""
    EM: torch.Tensor        # [4, K+1] match emission costs
    EI: torch.Tensor        # [4, K+1]
    TMM: torch.Tensor       # [K+1] transition costs by source position
    TMI: torch.Tensor
    TMD: torch.Tensor
    TIM: torch.Tensor
    TII: torch.Tensor
    TDM: torch.Tensor
    TDD: torch.Tensor
    entry: torch.Tensor     # [K+1]
    exit: torch.Tensor      # [K+1]
    t_NN: torch.Tensor      # scalars
    t_NB: torch.Tensor
    t_CC: torch.Tensor
    t_EC: torch.Tensor

    @property
    def K(self) -> int:
        return self.EM.shape[1] - 1

    @classmethod
    def from_profile(cls, hmm: ProfileHMM, device) -> "DeviceHMM":
        t = hmm.Tmat_cost
        dev = torch.device(device)
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                      device=dev)
        return cls(
            EM=f(hmm.E_M_cost), EI=f(hmm.E_I_cost),
            TMM=f(t[:, 0, 0]), TMI=f(t[:, 0, 1]), TMD=f(t[:, 0, 2]),
            TIM=f(t[:, 1, 0]), TII=f(t[:, 1, 1]),
            TDM=f(t[:, 2, 0]), TDD=f(t[:, 2, 2]),
            entry=f(hmm.entry_cost), exit=f(hmm.exit_cost),
            t_NN=f(hmm.t_NN_cost), t_NB=f(hmm.t_NB_cost),
            t_CC=f(hmm.t_CC_cost), t_EC=f(hmm.t_EC_cost),
        )


def full_dp_regions(n_rows: int, K: int) -> np.ndarray:
    """A single all-covering region with B-entry allowed (full DP)."""
    r = np.zeros((MAX_REGIONS, REGION_WIDTH), dtype=np.int32)
    r[0] = (1, K, 1, n_rows, 1, 0, 0, 0)
    return r


def banded_regions(vpaths: list[ViterbiAlignPath], K: int,
                   L_read: int) -> np.ndarray:
    """Region scalars replicating the reference's banded boundaries
    (reference calcViterbiScores banded, BandedHMMP7.cpp:782-892)."""
    r = np.zeros((MAX_REGIONS, REGION_WIDTH), dtype=np.int32)
    n = 0
    for p, vp in enumerate(vpaths):
        if p == 0:
            up_q = max(vp.from_ - 1, 0)
            up_start = max(int(vp.start - up_q * (1 + K_MIN_GAP_FRAC)), 1)
            up_from = max(int(vp.from_ - up_q * (1 + K_MIN_GAP_FRAC)), 1)
        else:
            prev = vpaths[p - 1]
            up_start = max(prev.end, 1)
            up_from = max(prev.to, 1)
        # upstream rectangle (B-entry allowed)
        r[n] = (up_start, vp.start, up_from, vp.from_, 1, 0, 0, 0)
        n += 1
        # the seed diagonal band (B-entry allowed, diag constrained)
        r[n] = (vp.start, vp.end, vp.from_, vp.to, 1, 1,
                -vp.n_del, vp.n_ins)
        n += 1
    last = vpaths[-1]
    down_q = L_read - last.to
    down_end = min(int(last.end + down_q * (1 + K_MIN_GAP_FRAC)), K)
    down_to = min(int(last.to + down_q * (1 + K_MIN_GAP_FRAC)), L_read)
    r[n] = (last.end, down_end, last.to, down_to, 0, 0, 0, 0)
    return r


def _row_masks(regions: torch.Tensor, i: int, jj: torch.Tensor):
    """allowed [B, K+1] and entry_ok [B, K+1] lane masks of row i from
    region scalars [B, R, 8]; jj = lane indices [K+1]."""
    j_lo, j_hi, i_lo, i_hi, entry, diag, lo_d, hi_d = (
        regions[:, :, c, None] for c in range(REGION_WIDTH))
    j = jj[None, None, :]
    in_rect = (j >= j_lo) & (j <= j_hi) & (i >= i_lo) & (i <= i_hi)
    dist = (i - i_lo) - (j - j_lo)      # diagnalDist (h:705-708)
    ok_diag = (diag == 0) | ((dist >= lo_d) & (dist <= hi_d))
    covered = in_rect & ok_diag
    return covered.any(1), (covered & (entry == 1)).any(1)


def shift_lanes(x: torch.Tensor, s: int, fill: float) -> torch.Tensor:
    """x[..., j] -> x[..., j-s] with `fill` in the first s lanes."""
    out = torch.full_like(x, fill)
    if s < x.shape[-1]:
        out[..., s:] = x[..., :-s]
    return out


def viterbi_scan(dh: DeviceHMM, codes: torch.Tensor, lengths: torch.Tensor,
                 regions: torch.Tensor, n_rows: int):
    """The batched Viterbi DP in plain tensor ops: a loop over the rows,
    each row a handful of [B, K+1] ops.

    codes: [B, n_rows] integer read bases (0..3; padding ignored)
    lengths: [B]; regions: [B, MAX_REGIONS, 8] band regions
    Returns (min_score [B] f32, min_i [B] int32, min_j [B] int32,
             choices [n_rows, B, K+1] uint8: bits 0-1 the M choice
             (0=B, 1=M, 2=I, 3=D), bit 2 the I choice, bit 3 the D choice).
    """
    dev = dh.EM.device
    f32 = dh.EM.dtype
    B = codes.shape[0]
    K = dh.K
    jj = torch.arange(K + 1, device=dev)
    codes = codes.to(torch.int64).clamp(0, 3)
    lengths = lengths.to(torch.int64)
    regions = regions.to(torch.int64)
    inf_t = torch.tensor(INF, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)

    TMM_sh = shift_lanes(dh.TMM, 1, INF)
    TIM_sh = shift_lanes(dh.TIM, 1, INF)
    TDM_sh = shift_lanes(dh.TDM, 1, INF)
    TMD_sh = shift_lanes(dh.TMD, 1, INF)
    TDD_sh = shift_lanes(dh.TDD, 1, INF)
    d_invalid = (jj <= 1) | (jj >= K)    # D1 and DK are wing-retracted

    Mp = torch.full((B, K + 1), INF, dtype=f32, device=dev)
    Ip = Mp.clone()
    Dp = Mp.clone()
    best = torch.full((B,), INF, dtype=f32, device=dev)
    best_i = torch.zeros(B, dtype=torch.int64, device=dev)
    best_j = torch.full((B,), torch.iinfo(torch.int32).max,
                        dtype=torch.int64, device=dev)
    choices = torch.empty((n_rows, B, K + 1), dtype=torch.uint8, device=dev)
    for i in range(1, n_rows + 1):
        b = codes[:, i - 1]
        em = dh.EM[b]                    # [B, K+1] (axis 0 = base)
        ei = dh.EI[b]
        col0 = (zero if i == 1 else dh.t_NN * float(i - 1)) + dh.t_NB
        allowed, entry_ok = _row_masks(regions, i, jj)
        allowed = allowed & (jj >= 1)
        entry_ok = entry_ok & (jj >= 1)

        optB = torch.where(entry_ok, col0 + dh.entry[None, :], inf_t)
        optM = shift_lanes(Mp, 1, INF) + TMM_sh
        optI = shift_lanes(Ip, 1, INF) + TIM_sh
        optD = shift_lanes(Dp, 1, INF) + TDM_sh
        stacked = torch.stack([optB, optM, optI, optD])     # [4, B, K+1]
        mn = stacked.min(dim=0).values
        Mn = em + mn
        # first minimum in the order B, M, I, D (whichMin, h:722-744)
        choiceM = torch.where(optB <= mn, 0, torch.where(
            optM <= mn, 1, torch.where(optI <= mn, 2, 3)))
        # traceback at j==1 considers only the B/I pair (cpp:966-973)
        choiceM[:, 1] = torch.where(optB[:, 1] <= optI[:, 1], 0, 2)
        Mn = torch.where(allowed, Mn, inf_t)
        Mn[:, 0] = col0

        iM = Mp + dh.TMI
        iI = Ip + dh.TII
        In = ei + torch.minimum(iM, iI)
        choiceI = (iM > iI).to(torch.int64)
        In = torch.where(allowed, In, inf_t)
        In[:, 0] = col0
        # j==0 I choice: current-row B column vs I(i-1,0) (cpp:978-983)
        choiceI[:, 0] = (Mn[:, 0] + dh.TMI[0]
                         > Ip[:, 0] + dh.TII[0]).to(torch.int64)

        # D chain x_j = min(a_j, x_{j-1} + c_j) as a min-plus doubling
        # scan in O(log K) depth
        Mn_sh = shift_lanes(Mn, 1, INF)
        dmask = ~d_invalid & allowed
        fresh = Mn_sh + TMD_sh
        a = torch.where(dmask, fresh, inf_t)
        c = torch.where(dmask, TDD_sh, inf_t)
        s = 1
        while s < K + 1:
            a = torch.minimum(shift_lanes(a, s, INF) + c, a)
            c = shift_lanes(c, s, 0.0) + c
            s *= 2
        Dn = torch.where(d_invalid, inf_t, a)
        # D choice: fresh from M(i,j-1) vs continue D(i,j-1) (cpp:996)
        choiceD = (fresh > shift_lanes(Dn, 1, INF) + TDD_sh).to(torch.int64)

        # final S row (cpp:772-779): M cols + IK exit, E->C, C loops
        rem = (lengths - i).to(f32)
        c_loops = torch.where(i < lengths, dh.t_CC * rem, zero)
        live = i <= lengths
        s_m = Mn + dh.exit[None, :] + dh.t_EC + c_loops[:, None]
        s_i = In[:, K] + dh.TIM[K] + dh.t_EC + c_loops
        s_m = torch.where(live[:, None], s_m, inf_t)
        s_i = torch.where(live, s_i, inf_t)
        row_all = torch.cat([s_m, s_i[:, None]], dim=1)     # [B, K+2]
        row_min = row_all.min(dim=1).values
        # column-major (j-first) first-occurrence tie-breaking like
        # Eigen minCoeff (cpp:945)
        row_j = torch.where(row_all == row_min[:, None],
                            torch.arange(K + 2, device=dev),
                            K + 2).min(dim=1).values
        upd = (row_min < best) | ((row_min == best) & (row_j < best_j))
        best = torch.where(upd, row_min, best)
        best_i = torch.where(upd, i, best_i)
        best_j = torch.where(upd, row_j, best_j)

        choices[i - 1] = (choiceM | (choiceI << 2) | (choiceD << 3)) \
            .to(torch.uint8)
        Mp, Ip, Dp = Mn, In, Dn
    return best, best_i.to(torch.int32), best_j.to(torch.int32), choices


def walk_choices(fetch, B: int, min_i: torch.Tensor, min_j: torch.Tensor,
                 K: int, max_steps: int):
    """Batched traceback (reference buildViterbiTrace,
    BandedHMMP7.cpp:943-1006) in tensor ops on the device of min_i;
    fetch(i, j) returns the 4-bit choice cell of each read at row i-1,
    lane j (both [B], already clamped into range).

    Returns (trace [B, max_steps] int8 REVERSED state codes 0=B, 1=M,
    2=I, 3=D, 5=pad, aln_start, aln_end, aln_from, aln_to), 1-based.
    The loop stops once every read is done: the remaining steps would
    only emit pads."""
    dev = min_i.device
    min_i = min_i.to(torch.int64)
    min_j = min_j.to(torch.int64)
    s = torch.where(min_j <= K, 1, 2)                   # M or I
    i = min_i.clone()
    j0 = torch.clamp(min_j, max=K)
    j = j0.clone()
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    emits = torch.full((B, max_steps), PAD_STATE, dtype=torch.int8,
                       device=dev)
    for t in range(max_steps):
        live = ~done & (i >= 1) & (j >= 0)
        if not bool(live.any()):
            break
        emits[:, t] = torch.where(live, s, PAD_STATE).to(torch.int8)
        ch = torch.where(live, fetch(i, j), 0)
        cm = ch & 3                                     # BMID code
        ci = (ch >> 2) & 1
        cd = (ch >> 3) & 1
        is_m, is_i, is_d = s == 1, s == 2, s == 3
        # next state by current state (cpp:966-1000)
        nxt_i = torch.where(j > 0, torch.where(ci == 0, 1, 2),
                            torch.where(ci == 0, 0, 2))
        nxt_d = torch.where(cd == 0, 1, 3)
        s_n = torch.where(is_m, cm, torch.where(
            is_i, nxt_i, torch.where(is_d, nxt_d, s)))
        i_n = i - (is_m | is_i).to(torch.int64)
        j_n = j - (is_m | is_d).to(torch.int64)
        # stop after emitting B, or when out of bounds
        done = done | (live & (s == 0)) | ~live
        s = torch.where(live, s_n, s)
        i = torch.where(live, i_n, i)
        j = torch.where(live, j_n, j)
    return emits, j + 1, j0, i + 1, min_i


def traceback_device(choices: torch.Tensor, min_i: torch.Tensor,
                     min_j: torch.Tensor, K: int, max_steps: int):
    """Batched traceback over the [n_rows, B, K+1] uint8 choice planes
    of viterbi_scan on their device: only the [B, max_steps] state
    strings go to the host.  Result as walk_choices."""
    n_rows, B, lanes = choices.shape
    ar = torch.arange(B, device=choices.device)

    def fetch(i, j):
        return choices[(i - 1).clamp(0, n_rows - 1), ar,
                       j.clamp(0, lanes - 1)].to(torch.int64)

    return walk_choices(fetch, B, min_i, min_j, K, max_steps)


def _walk_host(cell, min_i: int, min_j: int, K: int
               ) -> tuple[str, int, int, int, int]:
    """One read's traceback on the host; cell(i, j) is the 4-bit choice
    at row i-1, lane j."""
    s = "M" if min_j <= K else "I"
    i = min_i
    j = min_j if min_j <= K else K
    aln_end, aln_to = j, i
    trace = ["E"]
    codes_m = "BMID"
    while i >= 1 and j >= 0:
        trace.append(s)
        ch = cell(i, j)
        if s == "M":
            s = codes_m[ch & 3]
            i -= 1
            j -= 1
        elif s == "I":
            c = (ch >> 2) & 1
            s = ("MI" if j > 0 else "BI")[c]
            i -= 1
        elif s == "D":
            s = "MD"[(ch >> 3) & 1]
            j -= 1
        else:  # B
            break
    aln_start = j + 1
    aln_from = i + 1
    if trace[-1] != "B":
        trace.append("B")
    return "".join(reversed(trace)), aln_start, aln_end, aln_from, aln_to


def traceback(choices: np.ndarray, min_i: int, min_j: int, K: int
              ) -> tuple[str, int, int, int, int]:
    """Host traceback over the choice planes (reference
    buildViterbiTrace, BandedHMMP7.cpp:943-1006).

    choices: [n_rows, K+1] uint8 for ONE read (row r = seq pos r+1)
    Returns (trace, aln_start, aln_end, aln_from, aln_to), 1-based.
    """
    return _walk_host(lambda i, j: int(choices[i - 1, j]), min_i, min_j, K)


def traceback_packed(packed: np.ndarray, read: int, min_i: int,
                     min_j: int, K: int
                     ) -> tuple[str, int, int, int, int]:
    """Host traceback reading the nibble-packed planes directly (no
    bulk unpack; only the ~path-length cells are touched).

    packed: [n_rows/8, B, KP] int32 from cuda_viterbi.viterbi_planes.
    """
    plane = packed[:, read, :]

    def cell(i, j):
        shift = 4 * (7 - ((i - 1) & 7))
        return (int(plane[(i - 1) >> 3, j]) >> shift) & 15

    return _walk_host(cell, min_i, min_j, K)


def pack_choices(choices: torch.Tensor) -> torch.Tensor:
    """Pack two 4-bit choice cells per byte along the lane axis to
    halve the device->host transfer."""
    n_rows, B, lanes = choices.shape
    if lanes % 2:
        choices = torch.cat(
            [choices, torch.zeros((n_rows, B, 1), dtype=torch.uint8,
                                  device=choices.device)], dim=2)
    return choices[:, :, 0::2] | (choices[:, :, 1::2] << 4)


def unpack_choices(packed: np.ndarray, lanes: int) -> np.ndarray:
    out = np.empty(packed.shape[:-1] + (packed.shape[-1] * 2,),
                   dtype=np.uint8)
    out[..., 0::2] = packed & 0x0F
    out[..., 1::2] = packed >> 4
    return out[..., :lanes]


def _banded_failures(score_h, vpaths_per_read) -> np.ndarray:
    """[B] bool: reads whose banded DP found no finite path."""
    return np.array([not np.isfinite(score_h[r]) and bool(vpaths_per_read[r])
                     for r in range(len(score_h))])


class ViterbiAligner:
    """Batched aligner: device DP, host alignment-string build.

    device: "cuda" (default; raises without a card) or "cpu", where the
        kernels' plain PyTorch versions run.
    kernel: "cuda" (default) runs the DP in the hand-written kernel
        (the reference package's kernel="pallas"); "scan" runs
        viterbi_scan, the row recurrence in plain tensor ops.
    traceback_mode: "device" walks the choice planes on the device and
        ships only the state strings (in the kernel itself with
        kernel="cuda": K1); "host" downloads the planes (K4's packed
        planes with kernel="cuda") and walks them in Python.  Default:
        "device" for the kernel, "host" for the scan, as the reference
        package chooses."""

    def __init__(self, hmm: ProfileHMM, device="cuda", kernel: str = "cuda",
                 traceback_mode: str | None = None):
        if kernel not in ("cuda", "scan"):
            raise ValueError(f"kernel must be 'cuda' or 'scan', got "
                             f"{kernel!r}")
        if traceback_mode is None:
            traceback_mode = "device" if kernel == "cuda" else "host"
        if traceback_mode not in ("device", "host"):
            raise ValueError(f"traceback_mode must be 'device' or 'host', "
                             f"got {traceback_mode!r}")
        self.hmm = hmm
        self.device = resolve_device(device)
        self.kernel = kernel
        self.traceback_mode = traceback_mode
        self.refresh()

    @property
    def traced(self) -> bool:
        """The in-kernel-traceback contract (K1)."""
        return self.kernel == "cuda" and self.traceback_mode == "device"

    def refresh(self):
        """Re-stage cost arrays (after a mode change on the host hmm)."""
        from .cuda_viterbi import stage_costs
        self.dh = DeviceHMM.from_profile(self.hmm, self.device)
        self.staged = stage_costs(self.dh)

    def align_batch(self, seqs: list[str],
                    vpaths_per_read: list[list[ViterbiAlignPath] | None]
                    | None = None,
                    max_len: int | None = None) -> list[HmmAlignment]:
        """Align a batch of reads; vpaths_per_read[i] is None/[] for a
        full (unbanded) DP, else the seed paths for a banded DP."""
        return self.finalize_batch(
            self.dispatch_batch(seqs, vpaths_per_read, max_len))

    def _encode(self, seqs, vpaths_per_read, n_rows):
        hmm = self.hmm
        B = len(seqs)
        codes = np.zeros((B, n_rows), dtype=np.int32)
        lengths = np.zeros(B, dtype=np.int32)
        regions = np.zeros((B, MAX_REGIONS, REGION_WIDTH), dtype=np.int32)
        for r, s in enumerate(seqs):
            enc = hmm.abc.encode(s.upper())
            codes[r, :len(enc)] = np.clip(enc, 0, 3)
            lengths[r] = len(s)
            vps = vpaths_per_read[r]
            regions[r] = (banded_regions(vps, hmm.K, len(s)) if vps
                          else full_dp_regions(n_rows, hmm.K))
        return codes, lengths, regions

    def _run_dp(self, codes, lengths, regions, n_rows):
        """The untraced DP of a batch: (score, min_i, min_j, choices) on
        the device; choices are K4's packed planes or the scan's uint8
        planes."""
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)) \
            .to(self.device)
        if self.kernel == "cuda":
            from .cuda_viterbi import make_meta, viterbi_planes
            tc, em, scal = self.staged
            return viterbi_planes(tc, em, scal, to(np.clip(codes, 0, 3)),
                                  to(make_meta(lengths, regions)), n_rows,
                                  self.hmm.K)
        return viterbi_scan(self.dh, to(codes), to(lengths), to(regions),
                            n_rows)

    def dispatch_batch(self, seqs, vpaths_per_read=None,
                       max_len: int | None = None):
        """Launch the device DP without waiting for it; returns a handle
        for finalize_batch, so a caller can overlap the host stages of
        one batch with the DP of the next."""
        from .cuda_viterbi import PACK_ROWS, viterbi_traced_split
        B = len(seqs)
        if vpaths_per_read is None:
            vpaths_per_read = [None] * B
        n_rows = max_len or max((len(s) for s in seqs), default=1)
        if self.kernel == "cuda":
            n_rows = (n_rows + PACK_ROWS - 1) // PACK_ROWS * PACK_ROWS
        with trace.span("encode"):
            codes, lengths, regions = self._encode(seqs, vpaths_per_read,
                                                   n_rows)
        with _stage("dp_dispatch"):
            if not B:
                res = None
            elif self.traced:
                res = viterbi_traced_split(self.staged, self.hmm.K, codes,
                                           lengths, regions, n_rows)
            else:
                res = self._run_dp(codes, lengths, regions, n_rows)
            done = _done_event(self.device) if B else None
        trace.count("aln_reads", B)
        return (list(seqs), n_rows, codes, lengths, regions,
                vpaths_per_read, done, res)

    def finalize_batch(self, handle) -> list[HmmAlignment]:
        """Download a dispatched batch's result, re-run banded failures
        as full DP, and build the alignment strings."""
        if not handle[0]:
            return []
        if self.traced:
            return self._finalize_traced(handle)
        return self._finalize_planes(handle)

    def _finalize_traced(self, handle) -> list[HmmAlignment]:
        from .cuda_viterbi import (PAD_NIBBLE, PAD_WORD, unpack_emits,
                                   viterbi_traced_split)
        hmm = self.hmm
        (seqs, n_rows, codes, lengths, regions, vpaths_per_read, done,
         comb) = handle
        B = len(seqs)
        with _stage("dp"):
            _wait_if_timing(done)
        with _stage("scalars_dl"):
            comb_h = comb.cpu().numpy()
        score_h = comb_h[:, 0].view(np.float32)
        # banded failures -> full DP rerun of those rows, merged on the
        # host (the rerun's comb may be wider: pad both to one layout)
        failed = _banded_failures(score_h, vpaths_per_read)
        trace.count("band_fail", int(failed.sum()))
        if failed.any():
            rows = np.nonzero(failed)[0]
            regions2 = np.stack([full_dp_regions(n_rows, hmm.K)] *
                                len(rows))
            comb2_h = viterbi_traced_split(
                self.staged, hmm.K, codes[rows], lengths[rows], regions2,
                n_rows).cpu().numpy()
            wmax = max(comb_h.shape[1], comb2_h.shape[1])

            def _padw(a):
                out = np.full((a.shape[0], wmax), PAD_WORD, np.int32)
                out[:, :a.shape[1]] = a
                return out

            comb_h = _padw(comb_h)
            comb_h[rows] = _padw(comb2_h)
        with _stage("trace_dl"):
            sb_h = comb_h[:, :8].view(np.float32)
            score_h = sb_h[:, 0]
            emits = unpack_emits(comb_h[:, 8:])
            bounds = sb_h[:, 3:7].astype(np.int32)
        alns: list[HmmAlignment] = []
        with _stage("host_build"):
            for r in range(B):
                if not np.isfinite(score_h[r]):
                    alns.append(HmmAlignment())
                    continue
                path = emits[r][emits[r] != PAD_NIBBLE][::-1]   # forward
                if path.size and path[0] == 0:
                    path = path[1:]                             # implied B
                alns.append(build_global_align_path(
                    hmm, seqs[r], path, int(bounds[r, 0]),
                    int(bounds[r, 1]), int(bounds[r, 2]), int(bounds[r, 3]),
                    float(score_h[r])))
        return alns

    def _finalize_planes(self, handle) -> list[HmmAlignment]:
        hmm = self.hmm
        (seqs, n_rows, codes, lengths, regions, vpaths_per_read, done,
         res) = handle
        score, mi, mj, choices = res
        B = len(seqs)
        with _stage("dp"):
            _wait_if_timing(done)
        with _stage("scalars_dl"):
            score_h = score.cpu().numpy()
        # banded failures -> full DP rerun of those rows, written over
        # the first pass's rows on the device
        failed = _banded_failures(score_h, vpaths_per_read)
        trace.count("band_fail", int(failed.sum()))
        if failed.any():
            rows = np.nonzero(failed)[0]
            regions2 = np.stack([full_dp_regions(n_rows, hmm.K)] *
                                len(rows))
            s2, i2, j2, c2 = self._run_dp(codes[rows], lengths[rows],
                                          regions2, n_rows)
            rows_t = torch.from_numpy(rows).to(self.device)
            score = score.index_copy(0, rows_t, s2)
            mi = mi.index_copy(0, rows_t, i2)
            mj = mj.index_copy(0, rows_t, j2)
            choices = choices.index_copy_(1, rows_t, c2)
            score_h = score.cpu().numpy()

        host_k4 = self.kernel == "cuda" and self.traceback_mode == "host"
        if self.traceback_mode == "device":
            # scan + device walk: ship [B, steps] state codes, not the
            # choice planes
            max_steps = n_rows + hmm.K + 2
            emits, a_start, a_end, a_from, a_to = (
                x.cpu().numpy() for x in traceback_device(
                    choices, mi, mj, hmm.K, max_steps))
            codes_str = "BMIDE"

            def walk(r):
                path = emits[r][emits[r] != PAD_STATE]
                trace = "".join(codes_str[c] for c in path[::-1])
                if not trace.startswith("B"):
                    trace = "B" + trace
                return (trace + "E", int(a_start[r]), int(a_end[r]),
                        int(a_from[r]), int(a_to[r]))
        elif host_k4:
            with _stage("choices_dl"):
                packed_h = choices.cpu().numpy()
            with _stage("unpack"):
                mi_h, mj_h = mi.cpu().numpy(), mj.cpu().numpy()

            def walk(r):
                return traceback_packed(packed_h, r, int(mi_h[r]),
                                        int(mj_h[r]), hmm.K)
        else:
            mi_h, mj_h = mi.cpu().numpy(), mj.cpu().numpy()
            ch = unpack_choices(pack_choices(choices).cpu().numpy(),
                                hmm.K + 1)

            def walk(r):
                return traceback(ch[:, r], int(mi_h[r]), int(mj_h[r]),
                                 hmm.K)

        alns: list[HmmAlignment] = []
        with _stage("host_trace") if host_k4 else contextlib.nullcontext():
            for r in range(B):
                if not np.isfinite(score_h[r]):
                    alns.append(HmmAlignment())
                    continue
                alns.append(build_global_align(hmm, seqs[r], *walk(r),
                                               float(score_h[r])))
        return alns
