"""Frozen copy of tests/oracle/ref_phylo.py (commit 7ecd7fc), part of the benchmark's
plain reference; the original stays in place.  The seed search over every node is
done on the card in reference/judge.py, so oracle_get_seed and
oracle_assign_read are not kept.  Changed in the copy: the
three scaled primitives scale by each column's (each entry's) own max
always, not by the reference's conditional per-row max, which at the
gg_97 shape (site logliks near -1e5) underflows whole columns to -inf;
the value is the same where the reference's does not underflow.  An
optimisation with no valid site gives nan, as the C++ division does.

Oracle SEP placement: literal sequential f64 transcriptions of the
reference's seed/estimate/place/Q-value algorithms.

Sources transcribed:
- scaled log-space primitives (PhyloTreeUnrooted.h:1488-1529) with the
  reference's CONDITIONAL underflow scaling (scale only when the max is
  finite and below MIN_LOGLIK_EXP)
- SeqUtils::pDist (SeqUtils.cpp:38-54)
- getSeed / estimateSeq / filterPlacements / placeSeq / calcQValues
  (HmmUFOtu_main.cpp:127-216)
- PTUnrooted::estimateSeq (PhyloTreeUnrooted.cpp:849-877),
  estimateBranchLength{Unweighted,Weighted} (cpp:1018-1052),
  optimizeBranchLength 2-arg fixed point (cpp:749-798) and the joint
  3-branch loop (cpp:800-847), placeSeq (cpp:879-954),
  treeLoglik (cpp:707-712), logPriorPr (cpp:1166-1177)

The tree is consumed as plain data (parent/brlen/seqs/msg_up/msg_down/
heights/anno arrays of the production DB); every algorithm below is
re-derived from the C++, with per-site accumulations done by Python
left-to-right summation to match the reference's sequential loops.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .ref_model import RefModel

INF_V = -math.inf
BRANCH_EPS = 1e-5                 # cpp:71
MAX_ITER = 100
MAX_Q = 250


# ---------------------------------------------------------------------------
# scaled primitives (PhyloTreeUnrooted.h:1488-1529) — conditional scaling
# ---------------------------------------------------------------------------

def _scale(m):
    return np.where(np.isfinite(m), m, 0.0)


def dps_vec(P: np.ndarray, V: np.ndarray) -> np.ndarray:
    """dot_product_scaled(Vector4d P, Vector4d V) columnwise over [4,L]
    (PhyloTreeUnrooted.h:1506-1511), scaled by each column's max."""
    m = _scale(V.max(axis=0))
    with np.errstate(divide="ignore"):
        return np.log(P @ np.exp(V - m[None, :])) + m


def dps_mat(X: np.ndarray, V: np.ndarray) -> np.ndarray:
    """dot_product_scaled(Matrix4d X, Vector4d V) columnwise over [4,L]
    (PhyloTreeUnrooted.h:1496-1504), scaled by each column's max."""
    m = _scale(V.max(axis=0))
    with np.errstate(divide="ignore"):
        return np.log(X @ np.exp(V - m[None, :])) + m[None, :]


def row_mean_exp_scaled(X: np.ndarray) -> np.ndarray:
    """row_mean_exp_scaled over the last (rate) axis of [4, L, K]
    (PhyloTreeUnrooted.h:1521-1529), scaled by each entry's max over
    the rates."""
    m = _scale(X.max(axis=-1, keepdims=True))
    with np.errstate(divide="ignore"):
        return np.log(np.exp(X - m).mean(axis=-1)) + m[..., 0]


def tree_loglik(pi: np.ndarray, X: np.ndarray) -> float:
    """treeLoglik(pi, X, start, end) = sequential per-site sum of
    dot_product_scaled(pi, col) (PhyloTreeUnrooted.cpp:707-712)."""
    return sum(dps_vec(pi, X).tolist())


def p_dist(s1: np.ndarray, s2: np.ndarray, start: int, end: int) -> float:
    """SeqUtils::pDist digital-digital (SeqUtils.cpp:38-54); returns
    nan (0/0) when no site has both bases observed."""
    a = s1[start:end + 1]
    b = s2[start:end + 1]
    both = (a >= 0) & (b >= 0)
    N = int(both.sum())
    d = int(((a != b) & both).sum())
    if N == 0:
        return math.nan
    return d / N


# ---------------------------------------------------------------------------
# placement PODs
# ---------------------------------------------------------------------------

@dataclass
class OraclePTLoc:
    start: int
    end: int
    id: int
    dist: float


@dataclass
class OraclePlacement:
    start: int
    end: int
    c_node: int
    p_node: int
    a_node: int
    wuv: float
    ratio: float
    wnr: float
    loglik: float
    height: float = 0.0
    q_place: float = 0.0
    q_taxon: float = 0.0

    def get_anno_dist(self) -> float:
        """PTPlacement::getAnnoDist (PhyloTreeUnrooted.h:466-469)."""
        if self.a_node == self.c_node:
            return self.wuv * self.ratio + self.wnr
        return (1 - self.ratio) * self.wuv + self.wnr

    def log_prior(self, prior_type: str) -> float:
        """PTPlacement::logPriorPr (PhyloTreeUnrooted.cpp:1166-1177)."""
        if prior_type == "height":
            return -(self.get_anno_dist() - self.wnr + self.height)
        return -0.0


# ---------------------------------------------------------------------------
# tree data adapter
# ---------------------------------------------------------------------------

class OracleTree:
    """Plain-data view of a production PTUnrooted DB + RefModel."""


    def leaf_loglik(self, seq: np.ndarray, start: int,
                    end: int) -> np.ndarray:
        """getLeafLoglik(seq, start, end): [4, L] constant -inf with
        the [start, end] window filled (PhyloTreeUnrooted.h:1430-1444)."""
        L = self.cs_len
        out = np.full((4, L), INF_V)
        log_pi = np.log(self.pi)
        for j in range(start, end + 1):
            b = int(seq[j])
            if b >= 0:
                col = np.full(4, INF_V)
                col[b] = 0.0
                out[:, j] = col
            else:
                out[:, j] = log_pi
        return out

    def r_message(self, a_msg: np.ndarray, wa: float,
                  b_msg: np.ndarray, wb: float) -> np.ndarray:
        """loglik(r) for a root r with exactly two evaluated children
        carrying messages a_msg/b_msg over branches wa/wb
        (PhyloTreeUnrooted.cpp:315-345): per-rate loglikConv sums, then
        row_mean_exp_scaled when a DiscreteGamma model is set."""
        if self.rates is None:
            return dps_mat(self.model.Pr(wa), a_msg) + \
                dps_mat(self.model.Pr(wb), b_msg)
        cols = [dps_mat(self.model.Pr(wa * r), a_msg)
                + dps_mat(self.model.Pr(wb * r), b_msg)
                for r in self.rates]
        return row_mean_exp_scaled(np.stack(cols, axis=-1))

    def r_message3(self, U: np.ndarray, wu: float, V: np.ndarray,
                   wv: float, N: np.ndarray, wn: float) -> np.ndarray:
        """loglik(r) with all three children u, v, n evaluated."""
        if self.rates is None:
            return (dps_mat(self.model.Pr(wu), U)
                    + dps_mat(self.model.Pr(wv), V)
                    + dps_mat(self.model.Pr(wn), N))
        cols = [dps_mat(self.model.Pr(wu * r), U)
                + dps_mat(self.model.Pr(wv * r), V)
                + dps_mat(self.model.Pr(wn * r), N)
                for r in self.rates]
        return row_mean_exp_scaled(np.stack(cols, axis=-1))


# ---------------------------------------------------------------------------
# branch-length estimation / optimization
# ---------------------------------------------------------------------------

def estimate_branch_length(U: np.ndarray, V: np.ndarray, start: int,
                           end: int, method: str) -> float:
    """estimateBranchLength{Unweighted,Weighted}
    (PhyloTreeUnrooted.cpp:1018-1052).  Per-site terms are computed
    columnwise; the accumulations run left-to-right like the
    reference's site loop (integer counts for unweighted; sequential
    Python sums for weighted)."""
    Uw = U[:, start:end + 1]
    Vw = V[:, start:end + 1]
    b1 = Uw.argmax(axis=0)   # maxCoeff: first max wins ties
    b2 = Vw.argmax(axis=0)
    if method == "unweighted":
        d = float((b1 != b2).sum())
        return d / (end - start + 1)
    if method == "weighted":
        cols = np.arange(Uw.shape[1])
        pu = np.exp(Uw - Uw.max(axis=0, keepdims=True))
        pv = np.exp(Vw - Vw.max(axis=0, keepdims=True))
        w1 = pu[b1, cols] / pu.sum(axis=0)
        w2 = pv[b2, cols] / pv.sum(axis=0)
        ww = (w1 * w2).tolist()
        diff = (b1 != b2).tolist()
        d = 0.0
        N = 0.0
        for t in range(len(ww)):
            if diff[t]:
                d += ww[t]
            N += ww[t]
        return d / N
    raise ValueError(f"unknown method {method}")


def optimize_branch_length_2(pi: np.ndarray, U: np.ndarray,
                             V: np.ndarray, w0: float,
                             max_l: float) -> float:
    """Literal optimizeBranchLength(u, v, start, end, maxL)
    (PhyloTreeUnrooted.cpp:749-798).  U, V are the two directed branch
    messages already restricted to the evaluation window columns."""
    q0 = math.exp(-w0)
    p0 = 1 - q0
    p = p0
    q = q0
    log_a = dps_vec(pi, U + V)
    log_b = dps_vec(pi, U) + dps_vec(pi, V)
    # per-site evidence is iteration-invariant: exp(logA - scale),
    # exp(logB - scale) with scale = max(logA, logB), nan sites skipped
    # (the reference recomputes these per iteration, cpp:764-775)
    ok = ~(np.isnan(log_a) | np.isnan(log_b))
    scale = np.maximum(log_a, log_b)
    ea = np.where(ok, np.exp(log_a - scale), 0.0)
    eb = np.where(ok, np.exp(log_b - scale), 0.0)
    N = int(ok.sum())
    ok_l = ok.tolist()
    it = 0
    while it < MAX_ITER and 0 <= p <= 1:
        # skipped sites contribute an exact +0.0, preserving the
        # reference's left-to-right accumulation over valid sites
        terms = (eb * p0 / (ea * q0 + eb * p0 + (~ok))).tolist()
        psum = 0.0
        for t in range(len(terms)):
            if ok_l[t]:
                psum += terms[t]
        p = psum / N if N else math.nan     # C++: 0.0 / 0 is nan
        q = 1 - p
        if abs(math.log(q) - math.log(q0)) < BRANCH_EPS:
            break
        p0 = p
        q0 = q
        it += 1
    w = -math.log(q)
    if w > max_l:
        w = max_l
    return w


# ---------------------------------------------------------------------------
# SEP pipeline functions
# ---------------------------------------------------------------------------


def oracle_estimate_seq(ot: OracleTree, seq: np.ndarray,
                        loc: OraclePTLoc,
                        method: str = "unweighted") -> OraclePlacement:
    """Literal PTUnrooted::estimateSeq (PhyloTreeUnrooted.cpp:849-877).
    Fixed-rate convolutions regardless of the dGamma model."""
    u = loc.id
    v = int(ot.parent[u])
    c_dist = loc.dist
    pd = p_dist(ot.seqs[v], seq, loc.start, loc.end)
    denom = c_dist + pd
    ratio = c_dist / denom if denom != 0 else math.nan
    if math.isnan(ratio):
        ratio = 0.5
    w0 = float(ot.brlen[u])
    sl = slice(loc.start, loc.end + 1)
    U = ot.msg_up[u][:, sl]
    V = ot.msg_down[u][:, sl]
    Nl = ot.leaf_loglik(seq, loc.start, loc.end)[:, sl]
    wur = w0 * ratio
    wvr = w0 - wur
    UPr = dps_mat(ot.model.Pr(wur), U)
    VPr = dps_mat(ot.model.Pr(wvr), V)
    wnr = estimate_branch_length(UPr + VPr, Nl, 0, Nl.shape[1] - 1,
                                 method)
    loglik = tree_loglik(ot.pi,
                         UPr + VPr + dps_mat(ot.model.Pr(wnr), Nl))
    a_node = u if ratio <= 0.5 else v
    return OraclePlacement(loc.start, loc.end, u, v, a_node, w0,
                           ratio, wnr, loglik)


def oracle_filter_placements(places: list[OraclePlacement],
                             max_error: float) -> list[OraclePlacement]:
    """Literal filterPlacements (HmmUFOtu_main.cpp:162-173)."""
    places.sort(key=lambda p: -p.loglik)
    best = places[0].loglik
    cut = len(places)
    for t, p in enumerate(places):
        if best - p.loglik > max_error:
            cut = t
            break
    return places[:cut]


def oracle_place_seq(ot: OracleTree, seq: np.ndarray,
                     place: OraclePlacement,
                     max_height: float) -> OraclePlacement:
    """Literal placeSeq on the copied 2-node subtree + the joint
    3-branch optimization (PhyloTreeUnrooted.cpp:721-747, 800-847,
    879-954).

    The grafted star has root r with children u, v (messages fixed to
    the main tree's directed-edge caches) and the new leaf n.  The
    reference's setRoot(v)+evaluate(v) step only fills the r->v cache,
    which no later read uses — it is skipped here.
    """
    u, v = place.c_node, place.p_node
    sl = slice(place.start, place.end + 1)
    U = ot.msg_up[u][:, sl]
    V = ot.msg_down[u][:, sl]
    Nl = ot.leaf_loglik(seq, place.start, place.end)[:, sl]
    w0 = float(ot.brlen[u])

    # placeSeq initial branch lengths (cpp:899-907)
    wur = wur0 = w0 * place.ratio
    wvr = wvr0 = w0 * (1 - place.ratio)
    wnr = wnr0 = place.wnr
    # optimizeBranchLength(u, v, r, n) recomputes w0 as the sum
    w0_sum = wur0 + wvr0

    it = 0
    while it < MAX_ITER and 0 <= wur <= w0_sum:
        # setRoot(n); evaluate -> msg(r->n); optimize wnr (cap 1)
        Rn = ot.r_message(U, wur, V, wvr)
        wnr = optimize_branch_length_2(ot.pi, Rn, Nl, wnr, 1.0)
        # setRoot(u); evaluate -> msg(r->u); optimize wur (cap w0)
        Ru = ot.r_message(V, wvr, Nl, wnr)
        wur = optimize_branch_length_2(ot.pi, Ru, U, wur, w0_sum)
        wvr = w0_sum - wur
        if abs(wur - wur0) < BRANCH_EPS and abs(wnr - wnr0) < BRANCH_EPS:
            break
        wur0 = wur
        wvr0 = wvr
        wnr0 = wnr
        it += 1

    # final root loglik over the window (cpp:920-923)
    S = ot.r_message3(U, wur, V, wvr, Nl, wnr)
    place.loglik = tree_loglik(ot.pi, S)
    place.wnr = wnr
    place.ratio = wur / w0 if w0 != 0 else math.nan
    place.height = float(ot.heights[u]) + wur
    # aNode choice (cpp:949-952)
    if place.ratio <= 0.5 or ot.heights[v] > max_height:
        place.a_node = u
    else:
        place.a_node = v
    return place


def _add_scaled(log_a: float, log_b: float) -> float:
    """Math::add_scaled (math/Stats.h:233-236)."""
    scale = max(log_a, log_b)
    if scale == -math.inf:
        return -math.inf
    return math.log(math.exp(log_a - scale)
                    + math.exp(log_b - scale)) + scale


def _p2q(p: float) -> float:
    """Math::p2q (math/Stats.h:239-241)."""
    if p == 0:
        return math.inf
    return -10 * math.log(p) / math.log(10)


def oracle_calc_q_values(ot: OracleTree, places: list[OraclePlacement],
                         prior_type: str = "uniform"):
    """Literal calcQValues (HmmUFOtu_main.cpp:182-216)."""
    if not places:
        return places
    pp_place = []
    pp_taxon: dict[str, float] = {}
    pp_norm = -math.inf
    taxa = []
    for pl in places:
        p = pl.loglik + pl.log_prior(prior_type)
        pp_place.append(p)
        taxon = ot.anno[pl.a_node] if pl.a_node >= 0 else "UNASSIGNED"
        taxa.append(taxon)
        if taxon not in pp_taxon:
            pp_taxon[taxon] = p
        else:
            pp_taxon[taxon] = _add_scaled(pp_taxon[taxon], p)
        pp_norm = _add_scaled(pp_norm, p)
    mx = max(pp_place)
    w = [math.exp(x - mx) for x in pp_place]
    tot = sum(w)
    for t, pl in enumerate(places):
        q = _p2q(1 - w[t] / tot)
        pl.q_place = q if q <= MAX_Q else MAX_Q
    for t, pl in enumerate(places):
        q = _p2q(1 - math.exp(pp_taxon[taxa[t]] - pp_norm))
        pl.q_taxon = q if q <= MAX_Q else MAX_Q
    return places


