"""Frozen copy of tests/oracle/ref_hmm.py (commit 7ecd7fc), part of the benchmark's
plain reference; the original stays in place.  Only the full-matrix pieces the
benchmark uses are kept (the scores' end, the traceback, the alignment
string, the paired merge); the banded DP and the seed search are not.

Oracle profile-HMM alignment: literal sequential f64 transcriptions
of the reference's banded/full Viterbi DP, traceback and global
alignment building (src/BandedHMMP7.cpp:640-1186) plus
the alignSeq entry (src/HmmUFOtu_main.cpp:39-105).

Only trained parameter tables are taken from the production ProfileHMM
(as plain numbers); all control flow below is transcribed from the C++.
DP matrices are Python lists of f64 — every arithmetic op is IEEE
double, exactly like the reference's Eigen MatrixXd cells.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

INF = math.inf
M, I, D = 0, 1, 2           # p7 matching-state indices
GAP_SYM = "-"
PAD_SYM = "."

_ENC = {"A": 0, "C": 1, "G": 2, "T": 3,
        "a": 0, "c": 1, "g": 2, "t": 3}


def which_min4(pb: float, pm: float, pi_: float, pd: float,
               states: str = "BMID") -> str:
    """BandedHMMP7::whichMin 4-arg (BandedHMMP7.h:722-746): strict <,
    first state wins ties (inf everywhere -> states[0])."""
    idx = 0
    mn = INF
    if pb < mn:
        idx, mn = 0, pb
    if pm < mn:
        idx, mn = 1, pm
    if pi_ < mn:
        idx, mn = 2, pi_
    if pd < mn:
        idx, mn = 3, pd
    return states[idx]


def which_min2(pm: float, pid: float, states: str) -> str:
    """BandedHMMP7::whichMin 2-arg (BandedHMMP7.h:774-790)."""
    idx = 0
    mn = INF
    if pm < mn:
        idx, mn = 0, pm
    if pid < mn:
        idx, mn = 1, pid
    return states[idx]


@dataclass
class OracleVScores:
    """ViterbiScores (BandedHMMP7.h:198-228): (L+1)x(K+1) f64 DP
    matrices, all-inf on reset."""
    K: int
    L: int
    DP_M: list = field(default_factory=list)
    DP_I: list = field(default_factory=list)
    DP_D: list = field(default_factory=list)
    S: np.ndarray | None = None

    def __post_init__(self):
        self.reset()

    def reset(self):
        w = self.K + 1
        self.DP_M = [[INF] * w for _ in range(self.L + 1)]
        self.DP_I = [[INF] * w for _ in range(self.L + 1)]
        self.DP_D = [[INF] * w for _ in range(self.L + 1)]
        self.S = None


@dataclass
class OracleVTrace:
    """ViterbiAlignTrace (BandedHMMP7.h:254-272)."""
    min_score: float = INF
    aln_start: int = 0
    aln_end: int = 0
    aln_from: int = 0
    aln_to: int = 0
    aln_trace: str = ""


@dataclass
class OracleAlignment:
    """HmmAlignment essentials (BandedHMMP7.h:74-130)."""
    K: int = 0
    L: int = 0
    seq_start: int = 0
    seq_end: int = 0
    hmm_start: int = 0
    hmm_end: int = 0
    cs_start: int = 0
    cs_end: int = 0
    cost: float = INF
    align: str = ""

    def is_valid(self) -> bool:
        return (0 < self.seq_start <= self.seq_end
                and 0 < self.hmm_start <= self.hmm_end <= self.K
                and 0 < self.cs_start <= self.cs_end <= self.L
                and 0 <= self.cost < INF and self.L == len(self.align))

    def merge(self, other: "OracleAlignment") -> "OracleAlignment":
        """Paired-end merge (BandedHMMP7.cpp:1188-1213): the other's
        char only fills '.' pad positions of this alignment."""
        assert self.K == other.K and self.L == other.L
        self.seq_start = min(self.seq_start, other.seq_start)
        self.seq_end = max(self.seq_end, other.seq_end)
        self.hmm_start = min(self.hmm_start, other.hmm_start)
        self.hmm_end = max(self.hmm_end, other.hmm_end)
        self.cs_start = min(self.cs_start, other.cs_start)
        self.cs_end = max(self.cs_end, other.cs_end)
        self.cost += other.cost
        merged = [b if (a == PAD_SYM and b != PAD_SYM) else a
                  for a, b in zip(self.align, other.align)]
        self.align = "".join(merged)
        return self


class RefHmm:
    """Parameter snapshot + literal algorithm transcription."""

    def __init__(self, K: int, L: int, Tmat_cost, E_M_cost, E_I_cost,
                 entry: np.ndarray, exit_: np.ndarray,
                 t_NN_cost: float, t_NB_cost: float, t_CC_cost: float,
                 t_EC_cost: float, cs2profile, profile2cs):
        self.K = K
        self.L = L
        # [K+1][3][3] nested float lists
        self.Tmat_cost = [[[float(Tmat_cost[k][a][b]) for b in range(3)]
                           for a in range(3)] for k in range(K + 1)]
        self.E_M_cost = [[float(E_M_cost[b][k]) for k in range(K + 1)]
                         for b in range(4)]
        self.E_I_cost = [[float(E_I_cost[b][k]) for k in range(K + 1)]
                         for b in range(4)]
        self.entry = [float(x) for x in entry]     # probabilities
        self.exit = [float(x) for x in exit_]
        self.t_NN_cost = float(t_NN_cost)
        self.t_NB_cost = float(t_NB_cost)
        self.t_CC_cost = float(t_CC_cost)
        self.t_EC_cost = float(t_EC_cost)
        self.cs2profile = [int(x) for x in cs2profile]
        self.profile2cs = [int(x) for x in profile2cs]
        self.entry_cost = [INF] * (K + 1)
        self.exit_cost = [INF] * (K + 1)
        self.wing_retracted = False


    # ------------------------------------------------------------------
    def wing_retract(self):
        """Literal wingRetract (BandedHMMP7.cpp:1083-1120): fold the
        B->D1..Dj-1->Mj and Mi->Di+1..DK->E chains into entry/exit."""
        K = self.K
        Tc = self.Tmat_cost
        # entry: incremental prefix keeps the reference's exact
        # left-to-right accumulation order (cost rebuilt from MD0 each j)
        acc = Tc[0][M][D]           # B->D1
        for j in range(2, K + 1):
            if j > 2:
                acc = acc + Tc[j - 2][D][D]   # D_{j-2} -> D_{j-1}
            cost = acc + Tc[j - 1][D][M]      # D_{j-1} -> Mj
            self.entry[j] += math.exp(-cost)
            if self.entry[j] > 1:
                self.entry[j] = 1.0
        # exit: literal O(K^2) loop (each row's sum starts from MD_i)
        for i in range(1, K):
            cost = Tc[i][M][D]
            for j in range(i + 1, K):
                cost += Tc[j][D][D]
            cost += Tc[K][D][M]
            self.exit[i] += math.exp(-cost)
            if self.exit[i] > 1:
                self.exit[i] = 1.0
        self.entry_cost = [-math.log(p) if p > 0 else INF
                           for p in self.entry]
        self.exit_cost = [-math.log(p) if p > 0 else INF
                          for p in self.exit]
        self.wing_retracted = True

    # ------------------------------------------------------------------
    @staticmethod
    def encode(read: str) -> list[int]:
        return [_ENC[c] for c in read]


    def _finish_scores(self, vs: OracleVScores):
        """Build the S matrix (shared tail of both calcViterbiScores
        variants, BandedHMMP7.cpp:772-780 / 880-892)."""
        K, L = self.K, vs.L
        S = np.full((L + 1, K + 2), INF)
        S[:, : K + 1] = np.array(vs.DP_M, dtype=np.float64)
        S[:, K + 1] = np.array([row[K] for row in vs.DP_I])
        S[:, : K + 1] += np.array(self.exit_cost)[None, :]
        S[:, K + 1] += self.Tmat_cost[K][I][M]
        S += self.t_EC_cost
        for i in range(1, L):
            S[i, :] += self.t_CC_cost * (L - i)
        vs.S = S


    # ------------------------------------------------------------------
    def build_viterbi_trace(self, vs: OracleVScores) -> OracleVTrace:
        """Literal buildViterbiTrace (BandedHMMP7.cpp:943-1006)."""
        K = self.K
        vt = OracleVTrace()
        S = vs.S
        # Eigen minCoeff visits column-major with strict <; np.argmin on
        # the transpose reproduces that first-minimum tie order
        flat = int(np.argmin(S.T))
        min_col, min_row = divmod(flat, S.shape[0])
        vt.min_score = float(S[min_row, min_col])
        if vt.min_score == INF:
            return vt
        Mm, Im, Dm = vs.DP_M, vs.DP_I, vs.DP_D
        Tc = self.Tmat_cost
        s = "M" if min_col <= K else "I"
        i = min_row
        j = min_col if min_col <= K else K
        vt.aln_end = j
        vt.aln_to = i
        trace = ["E"]
        while i >= 1 and j >= 0:
            trace.append(s)
            if s == "M":
                if j > 1:
                    s = which_min4(Mm[i][0] + self.entry_cost[j],
                                   Mm[i - 1][j - 1] + Tc[j - 1][M][M],
                                   Im[i - 1][j - 1] + Tc[j - 1][I][M],
                                   Dm[i - 1][j - 1] + Tc[j - 1][D][M])
                else:
                    s = which_min2(Mm[i][0] + self.entry_cost[j],
                                   Im[i - 1][j - 1] + Tc[j - 1][I][M],
                                   "BI")
                i -= 1
                j -= 1
            elif s == "I":
                if j > 0:
                    s = which_min2(Mm[i - 1][j] + Tc[j][M][I],
                                   Im[i - 1][j] + Tc[j][I][I], "MI")
                else:
                    s = which_min2(Mm[i][0] + Tc[0][M][I],
                                   Im[i - 1][j] + Tc[j][I][I], "BI")
                i -= 1
            elif s == "D":
                s = which_min2(Mm[i][j - 1] + Tc[j - 1][M][D],
                               Dm[i][j - 1] + Tc[j - 1][D][D], "MD")
                j -= 1
            else:  # B
                break
        vt.aln_start = j + 1
        vt.aln_from = i + 1
        if trace[-1] != "B":
            trace.append("B")
        vt.aln_trace = "".join(reversed(trace))
        return vt

    # ------------------------------------------------------------------
    @staticmethod
    def get_padding_seq(L: int, insert: str, pad_ch: str,
                        mode: str) -> str:
        """Literal getPaddingSeq (BandedHMMP7.cpp:1137-1186)."""
        if not insert:
            return pad_ch * L
        n = len(insert)
        if mode == "LEFT":
            if n >= L:
                return insert[:L]
            return insert + pad_ch * (L - n)
        if mode == "RIGHT":
            if n >= L:
                return insert[n - L:]
            return pad_ch * (L - n) + insert
        if mode == "MIDDLE":
            if n >= L:
                o = (n - L) // 2
                return insert[o:o + L]
            lo = int(math.floor((L - n) / 2.0))
            hi = int(math.ceil((L - n) / 2.0))
            return pad_ch * lo + insert + pad_ch * hi
        if mode == "JUSTIFIED":
            if n >= L:
                lo = int(math.floor(L / 2.0))
                hi = int(math.ceil(L / 2.0))
                return insert[:lo] + insert[n - hi:]
            lo = int(math.floor(n / 2.0))
            hi = int(math.ceil(n / 2.0))
            return insert[:lo] + pad_ch * (L - n) + insert[:hi]
        return pad_ch * L

    def build_global_align(self, read: str, vs: OracleVScores,
                           vt: OracleVTrace) -> OracleAlignment:
        """Literal buildGlobalAlign (BandedHMMP7.cpp:1008-1081).

        NB: the bare `L` in the reference body is the PROFILE member
        csLen (BandedHMMP7.h), not the read length vs.L — the align
        string is over consensus coordinates."""
        L = self.L
        aln = OracleAlignment()
        seq_n = read[: vt.aln_from - 1]
        seq_c = read[vt.aln_to: vt.aln_to + (L - vt.aln_to)]
        cs_start = self.profile2cs[vt.aln_start]
        cs_end = self.profile2cs[vt.aln_end]
        out: list[str] = []
        j = 0
        k = 0
        insert = ""
        trace = vt.aln_trace
        ti = 0
        n_trace = len(trace)
        while ti < n_trace:
            state = trace[ti]
            if state == "B":
                out.append(self.get_padding_seq(cs_start - 1, seq_n,
                                                PAD_SYM, "RIGHT"))
                j = vt.aln_from
                k = vt.aln_start
            elif state == "M":
                if k > 1 and ti > 1 and \
                        self.profile2cs[k] - self.profile2cs[k - 1] > 1:
                    out.append(self.get_padding_seq(
                        self.profile2cs[k] - self.profile2cs[k - 1] - 1,
                        insert, GAP_SYM, "JUSTIFIED"))
                insert = ""
                out.append(read[j - 1])
                j += 1
                k += 1
            elif state == "I":
                ins: list[str] = []
                while ti < n_trace and trace[ti] == "I":
                    ins.append(read[j - 1].lower())
                    j += 1
                    ti += 1
                ti -= 1  # rewind
                insert = "".join(ins)
            elif state == "D":
                assert insert == ""
                if k > 1 and \
                        self.profile2cs[k] - self.profile2cs[k - 1] > 1:
                    out.append(GAP_SYM * (self.profile2cs[k]
                                          - self.profile2cs[k - 1] - 1))
                out.append(GAP_SYM)
                k += 1
            elif state == "E":
                assert j == vt.aln_to + 1
                out.append(self.get_padding_seq(L - cs_end, seq_c,
                                                PAD_SYM, "LEFT"))
            ti += 1
        aln.align = "".join(out)
        assert len(aln.align) == L
        aln.K = self.K
        aln.L = L
        aln.seq_start = vt.aln_from
        aln.seq_end = vt.aln_to
        aln.hmm_start = vt.aln_start
        aln.hmm_end = vt.aln_end
        aln.cs_start = cs_start
        aln.cs_end = cs_end
        aln.cost = vt.min_score
        return aln

    # ------------------------------------------------------------------


