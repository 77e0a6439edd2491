"""Judge a sample of the program's assignment rows against the plain
reference.

For each sampled row the reference aligns the read again (the profile
it estimated itself, a full f64 Viterbi) and places the program's
aligned read again (its own f64 messages over the read's columns, its
own inferred node sequences, then the frozen oracle's seed, estimate,
filter, place and Q values).  The program's row is only read.  The
numbers compared:

- aln_score_err: the worst |row cost - the reference's cost of the
  row's own path| (nats), the path read back from the row's alignment
  string (hmm_ref.path_score); single-end rows;
- aln_off_pct: the share of rows, in %, whose alignment (CS start, CS
  end and the aligned string) differs from the full-DP optimum's in
  more than ALN_OFF_COLS columns.  The program bands its DP around seed
  hits, as HmmUFOtu does, and a band that misses the optimum moves a
  few rows' alignments; a seed search or band at fault moves most;
- place_gap_ulps: the worst gap between the reference's best placement
  loglik and its loglik of the row's branch, ratio and pendant length,
  in f32 ulps of the best loglik's magnitude.  The program sums the
  whole tree's loglik (~1e7 nats here) in f32, where an ulp is ~1 nat,
  so it resolves its choice of branch and its ratio and pendant optima
  to a few ulps and no finer;
- loglik_rel_err: the worst |row loglik - reference loglik of the row's
  placement| over the latter's magnitude;
- q_place_ulps: the least change, in f32 ulps of the best loglik, to
  the reference's candidate logliks (the row's branch's raised, the
  others lowered, or the reverse) that puts the reference's error
  probability of the row's branch, 10^(-Q/10), where the row's
  Q_placement has it, to within the f32 spacing below 1 that the
  program works 1 - p out in; rows whose branch is among the reference's
  candidates;
- row_mismatch: rows whose branch is no edge, whose taxon id is not the
  branch end the ratio names, whose taxon is not that node's, that are
  unplaced on one side only, whose alignment is no path of the read,
  or (pairs) whose mates the reference orients otherwise.

Beside them, not compared: aln_band_excess, the worst row cost less the
full-DP optimum; aln_diff_cols, the most columns in which one row's
alignment differs from the optimum's; place_gap (nats), q_place_err
(error probabilities), and the rows that read the worst place_gap_ulps
and q_place_ulps (the rank of the row's branch among the reference's
candidates by loglik, its gap, the ulp, the columns).

fault="second_best" is a fault put in the program's place: each row's
placement is replaced by the reference's second-best candidate (its
branch, ratio, pendant, loglik and Q), which place_gap_ulps has to
catch.

Imports nothing of the program.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .hmm_ref import FastHmm, bf16, path_score, ref_hmm
from .messages import node_anno
from .ref_phylo import (OraclePTLoc, OracleTree, oracle_calc_q_values,
                        oracle_estimate_seq, oracle_filter_placements,
                        oracle_place_seq, tree_loglik, MAX_Q)

MAX_NSEED = 50          # assign -N default
MAX_ERROR = 20.0        # assign -e default
BLOCK = 2048            # widest column block whose messages are held at once
ALN_OFF_COLS = 32       # columns a row's alignment may differ from the optimum
THREADS = 4             # the full DPs run in this many threads
F32_ONE_ULP = 2.0 ** -24   # spacing of float32 numbers just below 1
LOGIT_FLOOR = math.log(F32_ONE_ULP)
ENC = np.full(256, -1, np.int8)
for _i, _c in enumerate(b"ACGT"):
    ENC[_c] = _i
    ENC[_c + 32] = _i

COLUMNS = ("id", "description", "seq_start", "seq_end", "hmm_start",
           "hmm_end", "CS_start", "CS_end", "cost", "alignment", "branch_id",
           "branch_ratio", "taxon_id", "taxon_anno", "anno_dist", "loglik",
           "Q_placement", "Q_taxon")


def parse_row(line: str) -> dict:
    f = line.rstrip("\n").split("\t")
    return dict(zip(COLUMNS, f))


class _View(OracleTree):
    """The frozen oracle's tree, fed with one column block's rows."""

    def __init__(self, tree, anno, rates):
        self.parent = tree.parent
        self.brlen = tree.brlen
        self.heights = np.zeros(len(tree.parent))
        self.anno = anno
        self.cs_len = tree.codes.shape[1]
        self.root = tree.root
        self.model = tree.model
        self.rates = None if rates is None else [float(r) for r in rates]
        self.pi = self.model.pi
        self.seqs, self.msg_up, self.msg_down = {}, {}, {}


def ulp32(x: float) -> float:
    """The spacing of float32 numbers at |x|."""
    return float(np.spacing(np.float32(abs(x))))


def _logit(e: float) -> float:
    """ln(e / (1 - e)), held at or above LOGIT_FLOOR."""
    if e <= 0:
        return LOGIT_FLOOR
    if e >= 1:
        return math.inf
    return max(math.log(e) - math.log1p(-e), LOGIT_FLOOR)


def q_ulps(q_row: float, logliks: list[float], t: int, ulp: float) -> float:
    """The least k such that moving the reference's candidate logliks by
    k ulps (candidate t's up and the others down, or the reverse) puts
    its error probability of t where the row's Q says: with the others'
    sum S of exp(L_i - L_t), the error probability is S / (1 + S), its
    log-odds ln S, and a move of k ulps shifts that by at most 2 k ulp.
    The row's Q is read as printed (6 significant digits)."""
    others = [x - logliks[t] for i, x in enumerate(logliks) if i != t]
    ref = LOGIT_FLOOR if not others else max(
        float(np.logaddexp.reduce(others)), LOGIT_FLOOR)
    if q_row >= MAX_Q * (1 - 1e-6):
        lo, hi = LOGIT_FLOOR, _logit(F32_ONE_ULP)
    else:
        lo = _logit(10 ** (-q_row * (1 + 5e-6) / 10) - F32_ONE_ULP)
        hi = _logit(10 ** (-q_row * (1 - 5e-6) / 10) + F32_ONE_ULP)
    return max(0.0, (ref - hi) / (2 * ulp), (lo - ref) / (2 * ulp))


def judge(rows, reads, tables, tree, mode, dev, log=None,
          control=False, fault=None) -> dict:
    """rows: parsed program rows; reads[i]: the read (str) or the mates
    (fwd, rev as sequenced) of rows[i]; tables: the reference profile;
    tree: messages.RefTree with rates set; mode 'ngcl' or 'global'.
    control: each single-end row's alignment fields are replaced by the
    reference's own alignment with its DP in bf16 before they are
    judged (the control of the alignment numbers).  fault:
    'second_best' (module docstring)."""
    from ..gen import revcom
    hmm = FastHmm(ref_hmm(tables, mode))
    low = FastHmm(hmm.ref, bf16) if control else None
    anno = node_anno(tree.names, tree.lineage)
    out = dict(aln_score_err=0.0, aln_off_pct=0.0, place_gap_ulps=0.0,
               loglik_rel_err=0.0, q_place_ulps=0.0, row_mismatch=0,
               aln_band_excess=0.0, aln_diff_cols=0, place_gap=0.0,
               q_place_err=0.0, q_worst=None, gap_worst=None, rows_judged=len(rows),
               rows_off=0, q_rows=0)

    def full_dp(rd):
        if isinstance(rd, tuple):
            return hmm.align(rd[0]), hmm.align(revcom(rd[1]))
        return hmm.align(rd), (low.align(rd) if low is not None else None)

    with ThreadPoolExecutor(THREADS) as ex:
        dps = list(ex.map(full_dp, reads))
    todo = []
    for row, rd, (a, b) in zip(rows, reads, dps):
        if isinstance(rd, tuple):
            if not (a.cs_start <= b.cs_start and a.cs_end <= b.cs_end):
                out["row_mismatch"] += 1
                continue
            a.merge(b)
        else:
            if b is not None:
                row = dict(row, seq_start=b.seq_start, seq_end=b.seq_end,
                           hmm_start=b.hmm_start, hmm_end=b.hmm_end,
                           CS_start=b.cs_start, CS_end=b.cs_end,
                           cost=repr(b.cost), alignment=b.align)
            sc = path_score(hmm.ref, rd, row)
            if sc is None:
                out["row_mismatch"] += 1
                continue
            out["aln_score_err"] = max(out["aln_score_err"],
                                       abs(float(row["cost"]) - sc))
        out["aln_band_excess"] = max(out["aln_band_excess"],
                                     float(row["cost"]) - a.cost)
        s1 = np.frombuffer(row["alignment"].encode(), np.uint8)
        s2 = np.frombuffer(a.align.encode(), np.uint8)
        diff = int((s1 != s2).sum()) if len(s1) == len(s2) else len(s2)
        diff += int(int(row["CS_start"]) != a.cs_start)
        diff += int(int(row["CS_end"]) != a.cs_end)
        out["aln_diff_cols"] = max(out["aln_diff_cols"], diff)
        out["rows_off"] += int(diff > ALN_OFF_COLS)
        todo.append(row)
    out["aln_off_pct"] = 100.0 * out["rows_off"] / max(len(rows), 1)
    # placement, by blocks of columns
    todo.sort(key=lambda r: int(r["CS_start"]))
    while todo:
        c0 = int(todo[0]["CS_start"]) - 1
        blk = [r for r in todo if int(r["CS_end"]) <= c0 + BLOCK]
        todo = todo[len(blk):]
        if not blk:                       # a row wider than a block
            blk, todo = [todo[0]], todo[1:]
        c1 = max(int(r["CS_end"]) for r in blk)
        _place_block(blk, c0, c1, tree, anno, dev, out, fault)
        if log:
            log(f"reference placed {len(blk)} rows over columns "
                f"[{c0}, {c1})")
    return out


def _second_best(row, places, view, anno):
    """The row with its placement replaced by the reference's
    second-best candidate by loglik."""
    if len(places) < 2:
        return row
    pl = sorted(places, key=lambda x: -x.loglik)[1]
    return dict(row, branch_id=f"{pl.c_node}->{pl.p_node}",
                branch_ratio=repr(pl.ratio), taxon_id=str(pl.a_node),
                taxon_anno=anno[pl.a_node],
                anno_dist=repr(pl.get_anno_dist()), loglik=repr(pl.loglik),
                Q_placement=repr(pl.q_place))


def _place_block(rows, c0, c1, tree, anno, dev, out, fault=None):
    import torch
    up, down = tree.messages(c0, c1, dev)
    st = tree.states(up, c0, c1)
    parent_t = torch.as_tensor(tree.parent, device=dev)
    view = _View(tree, anno, tree.rates)
    L = view.cs_len
    for row in rows:
        seq = ENC[np.frombuffer(row["alignment"].encode(), np.uint8)]
        start, end = int(row["CS_start"]) - 1, int(row["CS_end"]) - 1
        a, b = start - c0, end - c0 + 1
        q = torch.as_tensor(seq[start:end + 1].astype(np.int64), device=dev)
        s = st[:, a:b].to(torch.int64)
        both = (s >= 0) & (q[None, :] >= 0)
        n = both.sum(1)
        mis = ((s != q[None, :]) & both).sum(1)
        dist = torch.where(n > 0, mis.double() / n.clamp(min=1).double(),
                           torch.full_like(mis, 0, dtype=torch.float64)
                           + math.inf)
        dist = torch.where(parent_t >= 0, dist,
                           torch.full_like(dist, math.inf))
        _, order = torch.sort(dist, stable=True)
        top = order[:MAX_NSEED].cpu().numpy()
        dtop = dist[order[:MAX_NSEED]].cpu().numpy()
        seeds = [OraclePTLoc(start, end, int(u),
                             float(d) if np.isfinite(d) else math.nan)
                 for u, d in zip(top, dtop) if tree.parent[u] >= 0]
        c_p = row["branch_id"]
        port = None
        if c_p != "NULL":
            c, p = (int(x) for x in c_p.split("->"))
            port = (c, p)
        need = set(int(u) for u in top)
        need |= set(int(tree.parent[u]) for u in top if tree.parent[u] >= 0)
        if port:
            need |= {port[0], port[1]}
        need = sorted(x for x in need if 0 <= x < len(tree.parent))
        idx = torch.as_tensor(need, device=dev)
        u_rows = up[idx].cpu().numpy()
        d_rows = down[idx].cpu().numpy()
        s_rows = st[idx].cpu().numpy()
        for t, u in enumerate(need):
            full = np.full((4, L), -math.inf)
            full[:, c0:c1] = u_rows[t]
            view.msg_up[u] = full
            full = np.full((4, L), -math.inf)
            full[:, c0:c1] = d_rows[t]
            view.msg_down[u] = full
            sq = np.full(L, -1, np.int8)
            sq[c0:c1] = s_rows[t]
            view.seqs[u] = sq
        places = [oracle_estimate_seq(view, seq, loc) for loc in seeds]
        places = oracle_filter_placements(places, MAX_ERROR)
        for pl in places:
            oracle_place_seq(view, seq, pl, math.inf)
        places = [pl for pl in places if math.isfinite(pl.loglik)]
        oracle_calc_q_values(view, places, "uniform")
        places.sort(key=lambda x: -x.q_place)
        best = max(pl.loglik for pl in places)
        ulp = ulp32(best)
        if fault == "second_best":
            row = _second_best(row, places, view, anno)
            c_p = row["branch_id"]
            port = tuple(int(x) for x in c_p.split("->"))
        if port is None:
            out["row_mismatch"] += 1
            continue
        c, p = port
        ratio = float(row["branch_ratio"])
        a_node = int(row["taxon_id"])
        if tree.parent[c] != p or a_node != (c if ratio <= 0.5 else p) \
                or row["taxon_anno"] != anno[a_node]:
            out["row_mismatch"] += 1
            continue
        w0 = float(tree.brlen[c])
        ad = float(row["anno_dist"])
        wnr = ad - w0 * ratio if a_node == c else ad - (1 - ratio) * w0
        wur = w0 * ratio
        sl = slice(start, end + 1)
        Nl = view.leaf_loglik(seq, start, end)[:, sl]
        S = view.r_message3(view.msg_up[c][:, sl], wur,
                            view.msg_down[c][:, sl], w0 - wur, Nl,
                            max(wnr, 0.0))
        ll = tree_loglik(view.pi, S)
        if not math.isfinite(ll):
            out["row_mismatch"] += 1
            continue
        out["place_gap"] = max(out["place_gap"], best - ll)
        if (best - ll) / ulp >= out["place_gap_ulps"]:
            out["place_gap_ulps"] = (best - ll) / ulp
            by_ll = sorted(places, key=lambda x: -x.loglik)
            ranks = [r for r, pl in enumerate(by_ll) if pl.c_node == c]
            out["gap_worst"] = dict(
                id=row["id"], gap=best - ll, ulp=ulp, best=best,
                rank=ranks[0] if ranks else None, n_cand=len(places),
                cols=end - start + 1)
        out["loglik_rel_err"] = max(out["loglik_rel_err"],
                                    abs(float(row["loglik"]) - ll) / abs(ll))
        same = [t for t, pl in enumerate(places) if pl.c_node == c]
        if same:
            t = same[0]
            q_row = float(row["Q_placement"])
            out["q_rows"] += 1
            out["q_place_err"] = max(out["q_place_err"], abs(
                10 ** (-q_row / 10) - 10 ** (-places[t].q_place / 10)))
            k = q_ulps(q_row, [pl.loglik + pl.log_prior("uniform")
                               for pl in places], t, ulp)
            if k >= out["q_place_ulps"]:
                out["q_place_ulps"] = k
                out["q_worst"] = dict(
                    id=row["id"], q_row=q_row, q_ref=places[t].q_place,
                    rank=sorted(places, key=lambda x: -x.loglik).index(
                        places[t]), n_cand=len(places),
                    gap_ulps=(best - places[t].loglik) / ulp, ulp=ulp)
    del up, down, st
