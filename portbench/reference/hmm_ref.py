"""The profile HMM worked out again from the benchmark's own MSA, and a
full Viterbi alignment against it, in plain numpy f64.

estimate_hmm follows the reference's training (BandedHMMP7.cpp:386-541:
Henikoff weights, match columns by weighted symbol fraction, weighted
emission and transition counts, the five Dirichlet priors' posterior
means, the effective number tuned by bisection to a mean relative
entropy of 1 bit, local entry and exit from B->M1 and MK->E, then the
wing retraction), vectorised over columns.  align_read runs the full
DP of calcViterbiScores (BandedHMMP7.cpp:752-780) a read row at a time
over every profile position, then the frozen oracle's traceback and
alignment string (ref_hmm.py).  The program's aligner bands the DP
around seed hits; where the band holds the optimum both give the same
cost.

Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.special import gammaln

from .ref_hmm import INF, OracleVScores, RefHmm

M, I, D = 0, 1, 2
SYMFRAC = 0.5            # hmmufotu-build -f default
TARGET_ERE = 1.0         # mean relative entropy target, bits
MIN_BG_K = 350
ROW_CHUNK = 4096


# ---------------------------------------------------------------------------
# the Dirichlet prior file (BandedHMMP7Prior.cpp:38-60)
# ---------------------------------------------------------------------------

def load_prior(path: str) -> dict:
    """{'ME': (q [L], alpha [4, L]), 'IE': alpha [4], 'MT': alpha [3],
    'IT': alpha [2], 'DT': alpha [2]} from a .dm file."""
    lines = [ln.strip() for ln in open(path)]
    heads = {"Match emission:": "ME", "Insert emission:": "IE",
             "Match transition:": "MT", "Insert transition:": "IT",
             "Delete transition:": "DT"}
    out, i = {}, 0
    while i < len(lines):
        key = heads.get(lines[i])
        if key is None:
            i += 1
            continue
        j = i + 1
        if key == "ME":
            while not lines[j].startswith("K:"):
                j += 1
            k, l_ = (int(x) for x in lines[j].replace("K:", "")
                     .replace("L:", "").split())
            while not lines[j].startswith("Mixture coefficients:"):
                j += 1
            q = np.array([float(x) for x in lines[j + 1].split()])
            while not lines[j].startswith("alpha:"):
                j += 1
            a = np.array([[float(x) for x in lines[j + 1 + r].split()]
                          for r in range(k)])
            assert a.shape == (k, l_)
            out[key] = (q, a)
        else:
            while not lines[j].startswith("alpha:"):
                j += 1
            out[key] = np.array([float(x) for x in lines[j + 1].split()])
        i = j + 1
    return out


def _post_density(alpha, n):
    """Posterior mean of one Dirichlet: n [k, m] counts."""
    return (n + alpha[:, None]) / (n.sum(0) + alpha.sum())


def _post_mixture(q, alpha, n):
    """Posterior mean under a Dirichlet mixture: n [k, m] counts."""
    def lbeta(a, axis):
        return gammaln(a).sum(axis) - gammaln(a.sum(axis))
    a = alpha[:, :, None]
    nn = n[:, None, :]
    log_b = lbeta(a + nn, 0) - lbeta(alpha, 0)[:, None]        # [L, m]
    log_b -= log_b.max(0, keepdims=True)
    w = q[:, None] * np.exp(log_b)
    post = (a + nn) / (alpha.sum(0)[None, :, None] + n.sum(0)[None, None, :])
    x = (w[None] * post).sum(1)
    return x / x.sum(0, keepdims=True)


def _estimate_params(T, EM, EI, prior):
    """Posterior means in place of counts: T [K+1, 3, 3], EM/EI [4, K+1]."""
    K = T.shape[0] - 1
    T = T.copy()
    T[:, M, :] = _post_density(prior["MT"], T[:, M, :].T).T
    T[:, I, :2] = _post_density(prior["IT"], T[:, I, :2].T).T
    dt = _post_density(prior["DT"], np.stack([T[:, D, M], T[:, D, D]]))
    T[:, D, M], T[:, D, D] = dt[0], dt[1]
    EM = _post_mixture(*prior["ME"], EM)
    EI = _post_density(prior["IE"], EI)
    T[0, D, M], T[0, D, D] = 1.0, 0.0
    T[K, M, D], T[K, D, M], T[K, D, D] = 0.0, 1.0, 0.0
    return T, EM, EI


def _neglog(x):
    with np.errstate(divide="ignore"):
        return -np.log(x)


def estimate_hmm(codes: np.ndarray, prior_path: str,
                 symfrac: float = SYMFRAC) -> dict:
    """The trained profile's tables from leaf rows codes [N, L] (int8,
    -1 gap; columns that are gaps in every row are dropped first, as
    the MSA prune does).  Returns a dict of plain arrays: Tmat_cost,
    E_M_cost, E_I_cost, entry, exit (probabilities, local mode before
    the wing retraction), cs2profile, profile2cs, K, L, eff_n."""
    prior = load_prior(prior_path)
    keep = (codes >= 0).any(0)
    N, L = codes.shape[0], int(keep.sum())
    chunks = [slice(lo, min(lo + ROW_CHUNK, N))
              for lo in range(0, N, ROW_CHUNK)]

    def rows(c):
        return codes[c][:, keep]

    res_count = np.zeros((4, L), np.int64)
    for c in chunks:
        x = rows(c)
        for b in range(4):
            res_count[b] += (x == b).sum(0)
    r = (res_count != 0).sum(0)
    pssw = r[None, :] * res_count
    inv = np.where(pssw > 0, 1.0 / np.maximum(pssw, 1), 0.0)
    w = np.zeros(N)
    for c in chunks:
        x = rows(c)
        lens = (x >= 0).sum(1)
        wc = np.zeros(len(x))
        for b in range(4):
            wc += np.where(x == b, inv[b][None, :], 0.0).sum(1)
        w[c] = np.where(lens > 0, wc / np.maximum(lens, 1), wc)
    w *= N / w.sum()
    res_w = np.zeros((4, L))
    for c in chunks:
        x = rows(c)
        for b in range(4):
            res_w[b] += w[c] @ (x == b)
    gap_w = w.sum() - res_w.sum(0)              # every other cell is a gap
    sym_wfrac = res_w.sum(0) / (res_w.sum(0) + gap_w)
    is_match = sym_wfrac >= symfrac
    K = int(is_match.sum())
    profile2cs = np.zeros(K + 1, np.int64)
    profile2cs[1:] = np.nonzero(is_match)[0] + 1
    cs2profile = np.zeros(L + 2, np.int64)
    cs2profile[profile2cs[1:]] = np.arange(1, K + 1)
    cs2profile[profile2cs[K] + 1:] = K
    cs2k = np.cumsum(is_match)
    # a residue is M in a match column and I elsewhere, so the emission
    # counts are the weighted residue counts split by column
    EM = np.zeros((4, K + 1))
    EI = np.zeros((4, K + 1))
    for b in range(4):
        EM[b] = np.bincount(cs2k, res_w[b] * is_match, K + 1)
        EI[b] = np.bincount(cs2k, res_w[b] * ~is_match, K + 1)
        EM[b, 0] = (res_w[b] * is_match).sum()
    T = np.zeros((K + 1, 3, 3))
    for c in chunks:
        x = rows(c)
        wc = w[c]
        is_res = x >= 0
        sm = np.full(x.shape, 3, np.int8)
        sm[is_res & is_match[None, :]] = M
        sm[is_res & ~is_match[None, :]] = I
        sm[~is_res & is_match[None, :]] = D
        # transitions: each informative cell to the next one on its row
        rr, cc = np.nonzero(sm != 3)
        st = sm[rr, cc]
        same = rr[1:] == rr[:-1]
        cur, nxt = st[:-1], st[1:]
        ok = same & ~(((cur == I) & (nxt == D)) | ((cur == D) & (nxt == I)))
        flat = (cs2k[cc[:-1]][ok] * 3 + cur[ok]) * 3 + nxt[ok]
        T += np.bincount(flat, wc[rr[:-1]][ok], (K + 1) * 9).reshape(
            K + 1, 3, 3)
        has = is_res.any(1)
        first = is_res.argmax(1)
        last = x.shape[1] - 1 - is_res[:, ::-1].argmax(1)
        ii = np.nonzero(has)[0]
        np.add.at(T, (0, M, sm[ii, first[ii]]), wc[ii])
        np.add.at(T, (K, sm[ii, last[ii]], M), wc[ii])

    def ent_gap(x):
        Ts, EMs, EIs = _estimate_params(T * (x / N), EM * (x / N),
                                        EI * (x / N), prior)
        q = EM[:, 0] / EM[:, 0].sum()
        p = EMs[:, 1:]
        with np.errstate(divide="ignore", invalid="ignore"):
            terms = np.where(p > 0, p * np.log(p / q[:, None]), 0.0)
        return terms.sum() / K / math.log(2.0) - TARGET_ERE

    eff_n = _bisect(ent_gap, 0.0, float(N))
    if math.isnan(eff_n):
        eff_n = float(N)
    Tp, EMp, EIp = _estimate_params(T * (eff_n / N), EM * (eff_n / N),
                                    EI * (eff_n / N), prior)
    entry = np.r_[0.0, np.full(K, Tp[0, M, M])]
    exit_ = np.r_[0.0, np.full(K, Tp[K, M, M])]
    return dict(Tmat_cost=_neglog(Tp), E_M_cost=_neglog(EMp),
                E_I_cost=_neglog(EIp), entry=entry, exit=exit_,
                cs2profile=cs2profile, profile2cs=profile2cs,
                K=np.int64(K), L=np.int64(L), eff_n=np.float64(eff_n))


def _bisect(f, xl, xr, eps=1e-10):
    """RootFinder::rootBisection (RootFinder.cpp:22-70)."""
    fxl, fxr = f(xl), f(xr)
    if fxl * fxr >= 0:
        return math.nan
    while True:
        x = (xl + xr) / 2.0
        fx = f(x)
        if fx == 0:
            return x
        xmag = 0.0 if xl < 0 < xr else x
        if xr - xl < eps + eps * abs(xmag):
            return x
        if (fxl > 0) == (fx > 0):
            xl, fxl = x, fx
        else:
            xr, fxr = x, fx


def ref_hmm(tables: dict, mode: str) -> RefHmm:
    """The frozen oracle's RefHmm over these tables in a sequence mode
    ('ngcl' for single-end reads, 'global' for mates), wing-retracted."""
    K = int(tables["K"])
    p1 = max(K, MIN_BG_K) / (max(K, MIN_BG_K) + 1.0)
    term = 1 - p1
    t_nn, t_cc = {"global": (0.0, 0.0), "ngcl": (0.0, term),
                  "local": (term, term), "cgnl": (term, 0.0)}[mode]

    def cost(p):
        return -math.log(p) if p > 0 else INF
    ref = RefHmm(K, int(tables["L"]), tables["Tmat_cost"],
                 tables["E_M_cost"], tables["E_I_cost"],
                 [float(x) for x in tables["entry"]],
                 [float(x) for x in tables["exit"]],
                 cost(t_nn), cost(1.0 - t_nn), cost(t_cc), cost(1.0),
                 tables["cs2profile"], tables["profile2cs"])
    ref.wing_retract()
    return ref


def bf16(x):
    """x rounded to the nearest bfloat16 (ties to even), as float64."""
    x = np.asarray(x, np.float64)
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return np.where(np.isfinite(x), u.view(np.float32).astype(np.float64), x)


class FastHmm:
    """numpy copies of a RefHmm's tables for the row-at-a-time DP.
    rnd (the control's): every table entry and every DP cell is rounded
    with it, as a DP that stores its scores in that precision would."""

    def __init__(self, ref: RefHmm, rnd=None):
        self.ref = ref
        self.K = ref.K
        self.rnd = rnd or (lambda x: x)
        self.T = self.rnd(np.array(ref.Tmat_cost))            # [K+1, 3, 3]
        self.EM = self.rnd(np.array(ref.E_M_cost))            # [4, K+1]
        self.EI = self.rnd(np.array(ref.E_I_cost))
        self.entry = self.rnd(np.array(ref.entry_cost))
        dd = self.T[:, D, D]
        # P[j] = sum of dd[l - 1] for l in 3..j, the delete chain's cost
        self.pref = np.zeros(self.K + 1)
        if self.K >= 3:
            self.pref[3:] = np.cumsum(dd[2:self.K])

    def scores(self, enc: list[int]) -> OracleVScores:
        """calcViterbiScores over the full matrix, row by row."""
        ref, K, T = self.ref, self.K, self.T
        L = len(enc)
        vs = OracleVScores.__new__(OracleVScores)
        vs.K, vs.L = K, L
        Mm = np.full((L + 1, K + 1), INF)
        Im = np.full((L + 1, K + 1), INF)
        Dm = np.full((L + 1, K + 1), INF)
        for i in range(1, L + 1):
            base = 0.0 if i == 1 else ref.t_NN_cost * (i - 1)
            Mm[i, 0] = base + ref.t_NB_cost
        Im[:, 0] = Mm[:, 0]
        with np.errstate(invalid="ignore"):
            for i in range(1, L + 1):
                b = enc[i - 1]
                cand = np.minimum(np.minimum(Mm[i - 1, :K] + T[:K, M, M],
                                             Im[i - 1, :K] + T[:K, I, M]),
                                  Dm[i - 1, :K] + T[:K, D, M])
                cand = np.minimum(cand, Mm[i, 0] + self.entry[1:])
                Mm[i, 1:] = self.rnd(self.EM[b, 1:] + cand)
                Im[i, 1:] = self.rnd(self.EI[b, 1:] + np.minimum(
                    Mm[i - 1, 1:] + T[1:, M, I], Im[i - 1, 1:] + T[1:, I, I]))
                if K > 2:
                    a = Mm[i, 1:K - 1] + T[1:K - 1, M, D]          # j = 2..K-1
                    p = self.pref[2:K]
                    Dm[i, 2:K] = self.rnd(p + np.minimum.accumulate(a - p))
        vs.DP_M, vs.DP_I, vs.DP_D = Mm, Im, Dm
        ref._finish_scores(vs)
        vs.S = self.rnd(vs.S)
        return vs

    def align(self, read: str):
        """(OracleAlignment, optimum cost) of one read."""
        enc = RefHmm.encode(read)
        vs = self.scores(enc)
        vt = self.ref.build_viterbi_trace(vs)
        return self.ref.build_global_align(read, vs, vt)



def path_score(ref: RefHmm, read: str, row: dict):
    """The reference's least cost over the paths a row's alignment can
    stand for: the string fixes, at each match column from hmm_start to
    hmm_end, M (a base, which has to be the read's next one) or D ('-');
    between match columns its lower-case bases are an insert run of that
    length after the M before them, and where the run fills its columns
    (or the columns are none) the run's length is open, as is a run at
    the end after M_K.  The cost takes the DP's own terms: the B entry,
    transitions, emissions, the exit and the unaligned 3' bases.  None
    where the row is no path of this read."""
    p2c = ref.profile2cs
    T = np.asarray(ref.Tmat_cost)
    EM = np.asarray(ref.E_M_cost)
    EI = np.asarray(ref.E_I_cost)
    s = row["alignment"]
    i0, i1 = int(row["seq_start"]), int(row["seq_end"])
    k0, k1 = int(row["hmm_start"]), int(row["hmm_end"])
    K = ref.K
    r = np.array([_ENC4.get(c, -1) for c in read[i0 - 1:i1]], np.int64)
    if (r < 0).any():
        return None
    n = len(r)
    cM = np.full(n + 1, INF)
    cD = np.full(n + 1, INF)
    cI = np.full(n + 1, INF)
    base = (0.0 if i0 == 1 else ref.t_NN_cost * (i0 - 1)) + ref.t_NB_cost
    rb = np.frombuffer(read[i0 - 1:i1].upper().encode(), np.uint8)

    def slot(k, m, chars):
        """An insert run after M_k of length m (open: at least m)."""
        nonlocal cM, cD, cI
        e = EI[r, k] + T[k, I, I]
        Q = np.r_[0.0, np.cumsum(e)]
        out = np.full(n + 1, INF)
        if chars is not None:               # length m, these bases
            if m <= n:
                # a run shorter than its columns is written as its first
                # half, a gap, then its first (m + 1) // 2 bases again
                # (getPaddingSeq's "justified" mode, BandedHMMP7.cpp:1176)
                sel = np.r_[np.arange(m // 2), np.arange((m + 1) // 2)]
                ok = np.array([(rb[j:j + m][sel] == chars).all()
                               for j in range(n - m + 1)])
                v = cM[:n - m + 1] + T[k, M, I] - T[k, I, I] \
                    + Q[m:] - Q[:n - m + 1]
                out[m:] = np.where(ok, v, INF)
            cM, cD, cI = np.full(n + 1, INF), np.full(n + 1, INF), out
            return
        lo = max(m, 1)
        if lo <= n:
            best = np.minimum.accumulate(cM - Q)
            out[lo:] = T[k, M, I] - T[k, I, I] + Q[lo:] + best[:n + 1 - lo]
        if m > 0:
            cM, cD = np.full(n + 1, INF), np.full(n + 1, INF)
        cI = out

    first = True
    for k in range(k0, k1 + 1):
        if k > k0:
            gap = s[p2c[k - 1]:p2c[k] - 1]
            low = [c for c in gap if c.islower()]
            if len(low) == len(gap):                   # open length
                slot(k - 1, len(low), None)
            elif low:
                slot(k - 1, len(low), np.frombuffer(
                    "".join(low).upper().encode(), np.uint8))
            else:
                cI = np.full(n + 1, INF)
        c = s[p2c[k] - 1]
        if c == "-":
            if first or not 1 < k < K:
                return None
            nD = np.minimum(cM + T[k - 1, M, D], cD + T[k - 1, D, D])
            cM, cD, cI = np.full(n + 1, INF), nD, np.full(n + 1, INF)
        elif c.isupper():
            want = ord(c)
            nM = np.full(n + 1, INF)
            if first:
                nM[1] = base + ref.entry_cost[k]
            else:
                nM[1:] = np.minimum(np.minimum(cM[:-1] + T[k - 1, M, M],
                                               cI[:-1] + T[k - 1, I, M]),
                                    cD[:-1] + T[k - 1, D, M])
            nM[1:] += np.where(rb == want, EM[r, k], INF)
            cM, cD, cI = nM, np.full(n + 1, INF), np.full(n + 1, INF)
            first = False
        else:
            return None
    end = cM[n] + ref.exit_cost[k1]
    if k1 == K:
        slot(K, 0, None)
        end = min(end, cI[n] + T[K, I, M])
    if not end < INF:
        return None
    end += ref.t_EC_cost
    if i1 < len(read):
        end += ref.t_CC_cost * (len(read) - i1)
    return float(end)


_ENC4 = {"A": 0, "C": 1, "G": 2, "T": 3, "a": 0, "c": 1, "g": 2, "t": 3}
