"""Pipeline glue: align -> seed -> estimate -> filter -> place -> Q.

reference: src/HmmUFOtu_main.{h,cpp} — free functions alignSeq
(:39-125), getSeed (:127-152), estimateSeq (:154-160),
filterPlacements (:162-173), placeSeq (:175-180), calcQValues
(:182-216), alignIdentity/hmmIdentity (:218-239), JPlace (:241-247).

Counterpart of hmmufotu_tpu/pipeline.py: the host SEP functions are
the same; the device glue (assign_batch_device, dispatch/collect of a
placement batch, assign_stream) drives the port's ViterbiAligner and
DevicePlacer.  Results come back to the host with one .cpu() per batch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .hmm import (GLOBAL, HmmAlignment, ProfileHMM, ViterbiAligner,
                  ViterbiAlignPath)
from .index import CSFMIndex
from .phylo import PTLoc, PTPlacement, PTUnrooted
from .phylo.tree import MAX_Q
from .utils import trace

DEFAULT_SEED_LEN = 20       # hmmufotu.cpp:45
DEFAULT_SEED_REGION = 50    # hmmufotu.cpp:48
DEFAULT_MAX_NSEED = 50      # hmmufotu.cpp:44
DEFAULT_MAX_PLACE_ERROR = 20.0  # hmmufotu.cpp:49


def find_seed_vpaths(hmm: ProfileHMM, csfm: CSFMIndex, read: str,
                     seed_len: int = DEFAULT_SEED_LEN,
                     seed_region: int = DEFAULT_SEED_REGION,
                     mode: str = GLOBAL,
                     rng: np.random.Generator | None = None):
    """Scan 5' (and for GLOBAL mode 3') windows for an FM-index seed
    hit yielding a valid align path (reference alignSeq seeding,
    HmmUFOtu_main.cpp:52-84)."""
    vpaths = []
    n = len(read)
    region = min(seed_region, n)
    for frm in range(0, region - seed_len + 1):
        loc = csfm.locate_one(read[frm:frm + seed_len], rng)
        if loc.is_valid():
            vp = hmm.build_align_path(loc, frm + 1, frm + seed_len)
            if vp.is_valid():
                vpaths.append(vp)
                break
    if mode == GLOBAL and (not vpaths or n >= 2 * region):
        for to in range(n - 1, -1, -1):
            frm = to - seed_len + 1
            if frm < n - region:
                break
            loc = csfm.locate_one(read[frm:to + 1], rng)
            if loc.is_valid():
                vp = hmm.build_align_path(loc, frm + 1, to + 1)
                if vp.is_valid():
                    vpaths.append(vp)
                    break
    return vpaths


def _align_paths_batch(hmm: ProfileHMM, csfm: CSFMIndex,
                       starts: np.ndarray, offs: np.ndarray,
                       wins: np.ndarray, pats: list[str]):
    """Closed-form batched CSLoc -> ViterbiAlignPath construction.

    Equivalent to csfm._cs_loc + hmm.build_align_path per hit
    (reference extractCS, CSFMIndex.cpp:262-273 + buildAlignPath,
    BandedHMMP7.cpp:894-940) without materializing the gapped CS
    strings: for strictly increasing consensus positions the walked
    CS range is [cs_pos[0], cs_pos[-1]] and every quantity reduces to
    prefix-sum lookups.  Non-monotone hits (separator matches from
    degenerate read chars) fall back to the exact per-hit path.

    starts: [H] concat positions; offs: [H] 0-based read offsets;
    wins: [H, plen] encoded window codes (csfm._encode: symbols 1..4);
    pats: the window strings (fallback only).
    Returns a list of ViterbiAlignPath.
    """
    H, plen = wins.shape
    cs2p = hmm.cs2profile
    tables = getattr(hmm, "_cs_match_tables", None)
    if tables is None or tables[0].shape[0] != cs2p.shape[0]:
        nz = cs2p != 0
        idx = np.arange(len(cs2p), dtype=np.int64)
        mp = np.cumsum(nz)                       # k!=0 count <= cs
        nxt = np.where(nz, idx, len(cs2p) - 1)   # next k!=0 pos >= cs
        nxt = np.minimum.accumulate(nxt[::-1])[::-1].copy()
        prv = np.where(nz, idx, 0)               # prev k!=0 pos <= cs
        prv = np.maximum.accumulate(prv)
        hmm._cs_match_tables = (mp, nxt, prv)
    mp, nxt, prv = hmm._cs_match_tables

    cs_pos = csfm.concat2cs[
        starts[:, None] + np.arange(plen)].astype(np.int64)  # [H, plen]
    a = cs_pos[:, 0]
    b = cs_pos[:, -1]
    mono = (a >= 1)
    if plen > 1:
        mono &= (np.diff(cs_pos, axis=1) >= 1).all(axis=1)
    sym = (wins >= 1) & (wins <= 4)
    m = sym.sum(axis=1)
    a_c = np.maximum(a, 1)
    npos_k = mp[b] - mp[a_c - 1]
    sp = nxt[a_c]
    start_k = np.where(sp <= b, cs2p[np.minimum(sp, len(cs2p) - 1)], 0)
    ep = prv[b]
    end_k = np.where(ep >= a_c, cs2p[ep], 0)
    k_pat = cs2p[cs_pos]
    n_del = npos_k - (sym & (k_pat != 0)).sum(axis=1)
    n_ins = (sym & (k_pat == 0)).sum(axis=1)
    from_ = np.where(m > 0, offs + 1, 0)
    to = offs + m

    out = []
    for h in range(H):
        if mono[h]:
            out.append(ViterbiAlignPath(
                int(start_k[h]), int(end_k[h]), int(from_[h]),
                int(to[h]), int(n_ins[h]), int(n_del[h])))
        else:
            loc = csfm._cs_loc(int(starts[h]), pats[h])
            out.append(hmm.build_align_path(loc, int(offs[h]) + 1,
                                            int(offs[h]) + plen))
    return out


def batch_find_seed_vpaths(hmm: ProfileHMM, csfm: CSFMIndex,
                           reads: list[str],
                           seed_len: int = DEFAULT_SEED_LEN,
                           seed_region: int = DEFAULT_SEED_REGION,
                           mode: str = GLOBAL,
                           rng: np.random.Generator | None = None):
    """Lockstep seed search for a whole read batch.

    All (read, window) k-mers run through ONE batched backward search
    (csfm._backward_search); per read the first hit window is selected
    — the same window the reference's sequential scan with early break
    would pick (HmmUFOtu_main.cpp:52-84).  Window emission, hit
    selection and RNG draws are fully vectorized; random draws happen
    in read order (one per hit read per side), so seeded runs stay
    byte-identical to the per-read scan.  Traced as span "seed", with
    counters seed_reads and seed_miss (reads with no valid seed path on
    either side, which get a full DP)."""
    with trace.span("seed"):
        out = _seed_search(hmm, csfm, reads, seed_len, seed_region, mode,
                           rng)
    if trace.ON:
        trace.count("seed_reads", len(out))
        trace.count("seed_miss", sum(1 for v in out if not v))
    return out


def _seed_search(hmm, csfm, reads, seed_len, seed_region, mode, rng):
    B = len(reads)
    out: list[list[ViterbiAlignPath]] = [[] for _ in range(B)]
    if B == 0:
        return out
    lens = np.array([len(r) for r in reads], dtype=np.int64)
    Lmax = int(lens.max())
    if Lmax < seed_len:
        return out
    enc = np.zeros((B, Lmax), dtype=np.int64)
    for r, read in enumerate(reads):
        enc[r, : lens[r]] = csfm._encode(read)
    region = np.minimum(seed_region, lens)
    nwin = region - seed_len + 1        # windows per side per read
    Kw = int(nwin.max())
    if Kw <= 0:
        return out
    kk = np.arange(Kw)

    def run_side(five_prime: bool):
        if five_prime:
            offs = np.broadcast_to(kk, (B, Kw))
            skip = np.zeros(B, dtype=bool)
        else:
            # 3' windows scan right-to-left (off descending)
            offs = (lens - seed_len)[:, None] - kk[None, :]
            skip = np.array([bool(out[r]) and lens[r] < 2 * region[r]
                             for r in range(B)])
        valid = ((kk[None, :] < nwin[:, None]) & (offs >= 0)
                 & (lens[:, None] >= seed_len) & ~skip[:, None])
        offs_c = np.clip(offs, 0, max(Lmax - seed_len, 0))
        # windows via a strided view + row gather (a 3-level fancy
        # index here costs ~100x more than the whole FM search)
        from numpy.lib.stride_tricks import sliding_window_view
        sw = sliding_window_view(enc, seed_len, axis=1)
        win = sw[np.arange(B)[:, None], offs_c]
        flat = np.ascontiguousarray(win.reshape(B * Kw, seed_len))
        vmask = valid.reshape(-1)
        if not vmask.any():
            return
        s = np.zeros(B * Kw, dtype=np.int64)
        e = np.full(B * Kw, -1, dtype=np.int64)
        sv, ev = csfm._backward_search(flat[vmask])
        s[vmask] = sv
        e[vmask] = ev
        hit = ((s <= e) & vmask).reshape(B, Kw)
        has = hit.any(axis=1)
        first = hit.argmax(axis=1)          # first hit in scan order
        rows_idx = np.nonzero(has)[0]
        if rows_idx.size == 0:
            return
        ks = rows_idx * Kw + first[rows_idx]
        srows = s[ks]
        if rng is not None:
            spans = e[ks] - srows + 1
            srows = srows + (rng.integers(0, 2**62, size=len(ks))
                             % spans)
        starts = csfm._access_sa(srows)
        h_offs = offs[rows_idx, first[rows_idx]].astype(np.int64)
        h_wins = flat[ks]
        pats = [reads[r][int(h_offs[t]):int(h_offs[t]) + seed_len]
                for t, r in enumerate(rows_idx)]
        vps = _align_paths_batch(hmm, csfm, starts, h_offs, h_wins,
                                 pats)
        for t, r in enumerate(rows_idx):
            if vps[t].is_valid():
                out[r].append(vps[t])

    run_side(True)
    if mode == GLOBAL:
        run_side(False)
    return out


def align_reads(aligner: ViterbiAligner, csfm: CSFMIndex,
                reads: list[str],
                seed_len: int = DEFAULT_SEED_LEN,
                seed_region: int = DEFAULT_SEED_REGION,
                mode: str = GLOBAL,
                rng: np.random.Generator | None = None
                ) -> list[HmmAlignment]:
    """Banded-align a read batch (reference alignSeq per read,
    HmmUFOtu_main.cpp:39-105, with full-DP fallback built into the
    aligner)."""
    vpaths = batch_find_seed_vpaths(aligner.hmm, csfm, reads, seed_len,
                                    seed_region, mode, rng)
    return aligner.align_batch(reads, vpaths)


def aln_to_digital(tree: PTUnrooted, aln: HmmAlignment) -> np.ndarray:
    """Encode the gapped alignment string as an int8 digital seq of
    csLen (pads '.' and gaps both encode to GAP_BASE)."""
    from .alphabet import DNA
    return DNA.encode_upper(aln.align)


def aln_to_digital_win(aln: HmmAlignment, sc: int, W: int) -> np.ndarray:
    """Encode only the W-wide window of the alignment string starting
    at 0-based CS position sc — everything outside [cs_start, cs_end]
    is '.' pad (GAP_BASE) anyway, so the window plus a device-side
    scatter reproduces aln_to_digital exactly at ~W/csLen the host
    encode + transfer cost."""
    from .alphabet import DNA
    return DNA.encode_upper(aln.align[sc:sc + W])


def get_seed(tree: PTUnrooted, seq: np.ndarray, start: int, end: int,
             max_diff: float = math.inf,
             max_height: float = math.inf,
             max_nseed: int = DEFAULT_MAX_NSEED) -> list[PTLoc]:
    """p-dist of the aligned read to every non-root node, vectorized
    as masked mismatch counting over the [N, csLen] node-seq matrix
    (reference getSeed, HmmUFOtu_main.cpp:127-152)."""
    window = slice(start, end + 1)
    seqs = tree.seqs[:, window]                    # [N, w] int8
    q = seq[window][None, :]
    both = (seqs >= 0) & (q >= 0)
    n_inf = both.sum(axis=1)
    n_mis = ((seqs != q) & both).sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        dist = np.where(n_inf > 0, n_mis / np.maximum(n_inf, 1), np.nan)
    eligible = (tree.parent >= 0) & (tree.heights <= max_height)
    ids = np.nonzero(eligible)[0]
    order = ids[np.argsort(dist[ids], kind="stable")]
    locs = [PTLoc(start, end, int(u), float(dist[u])) for u in order]
    if locs:
        best = locs[0].dist
        worst = locs[-1].dist
        # reference quirk (HmmUFOtu_main.cpp:143-151): the max_diff
        # filter only runs when worst < best + max_diff; a spread wider
        # than max_diff keeps ALL seeds
        if worst < best + max_diff:
            locs = [l for l in locs if not (l.dist - best > max_diff)]
    if len(locs) > max_nseed:
        locs = locs[:max_nseed]   # hmmufotu.cpp:650-652
    return locs


def estimate_seq(tree: PTUnrooted, seq: np.ndarray, locs: list[PTLoc],
                 method: str = "unweighted") -> list[PTPlacement]:
    return [tree.estimate_seq(seq, loc, method) for loc in locs]


def filter_placements(places: list[PTPlacement],
                      max_error: float = DEFAULT_MAX_PLACE_ERROR
                      ) -> list[PTPlacement]:
    places.sort(key=lambda p: -p.loglik)
    best = places[0].loglik
    return [p for p in places if best - p.loglik <= max_error]


def place_seq(tree: PTUnrooted, seq: np.ndarray,
              places: list[PTPlacement],
              max_height: float = math.inf) -> list[PTPlacement]:
    for p in places:
        tree.place_seq(seq, p, max_height)
    return places


def add_scaled(lhs: float, rhs: float) -> float:
    """log(exp(lhs) + exp(rhs)) with scaling
    (reference Math::add_scaled, math/Stats.h:233)."""
    if lhs == -math.inf:
        return rhs
    if rhs == -math.inf:
        return lhs
    m = max(lhs, rhs)
    return m + math.log(math.exp(lhs - m) + math.exp(rhs - m))


def p2q(p: float) -> float:
    """Phred transform (reference math/Stats.h:239-245)."""
    if p <= 0:
        return math.inf
    return -10.0 * math.log10(p)


def q2p(q: float) -> float:
    return 10 ** (-q / 10.0)


def calc_q_values(tree: PTUnrooted, places: list[PTPlacement],
                  prior_type: str = "uniform"):
    """Posterior placement/taxon Q values (reference calcQValues,
    HmmUFOtu_main.cpp:182-216)."""
    if not places:
        return places
    pp = np.array([p.loglik + p.log_prior(prior_type, tree)
                   for p in places])
    taxon_names = [tree.anno[p.a_node] if p.a_node >= 0 else "UNASSIGNED"
                   for p in places]
    pp_taxon: dict[str, float] = {}
    norm = -math.inf
    for name, v in zip(taxon_names, pp):
        pp_taxon[name] = v if name not in pp_taxon \
            else add_scaled(pp_taxon[name], v)
        norm = add_scaled(norm, v)
    w = np.exp(pp - pp.max())
    w = w / w.sum()
    for i, p in enumerate(places):
        p.q_place = min(p2q(1 - w[i]), MAX_Q)
        p.q_taxon = min(p2q(1 - math.exp(pp_taxon[taxon_names[i]] - norm)),
                        MAX_Q)
    return places


def align_identity(abc, align: str, start: int, end: int) -> float:
    """Fraction of non-gap over the aligned CS region (reference
    alignIdentity, HmmUFOtu_main.cpp:218-226)."""
    region = align[start:end + 1]
    n = sum(1 for c in region if abc.is_symbol_char(c))
    return n / (end - start + 1)


def hmm_identity(hmm: ProfileHMM, align: str, start: int,
                 end: int) -> float:
    """Fraction of non-gap over profile sites in the region (reference
    hmmIdentity, HmmUFOtu_main.cpp:228-239)."""
    n = n_site = 0
    for i in range(start, end + 1):
        if hmm.get_profile_loc(i + 1) != 0:
            n_site += 1
            if hmm.abc.is_symbol_char(align[i]):
                n += 1
    return n / n_site if n_site else math.nan


@dataclass
class JPlace:
    """One jplace placement row (reference JPlace,
    HmmUFOtu_main.h:48-68, cpp:241-247)."""
    edge_id: int
    read_name: str
    likelihood: float
    distal_length: float
    proximal_length: float
    pendant_length: float
    like_ratio: float

    @classmethod
    def from_placement(cls, tree: PTUnrooted, read_name: str,
                       place: PTPlacement) -> "JPlace":
        edge_len = place.wuv
        ratio = place.ratio
        anno_dist = place.get_anno_dist(tree)
        distal = edge_len * ratio
        proximal = edge_len * (1 - ratio)
        pendant = anno_dist - distal if ratio <= 0.5 \
            else anno_dist - proximal
        like_ratio = 1.0 if place.q_place >= MAX_Q else q2p(place.q_place)
        return cls(place.c_node, read_name, place.loglik, distal,
                   proximal, pendant, like_ratio)


def assign_read(tree: PTUnrooted, aln: HmmAlignment, seq: np.ndarray,
                max_diff: float = math.inf,
                max_height: float = math.inf,
                max_nseed: int = DEFAULT_MAX_NSEED,
                max_error: float = DEFAULT_MAX_PLACE_ERROR,
                method: str = "unweighted",
                prior_type: str = "uniform",
                ml_only: bool = False,
                ref_rank: bool = False) -> PTPlacement | None:
    """Full SEP placement of one aligned read; returns the best
    placement (reference hmmufotu.cpp task body, :640-751).

    ref_rank emulates the v1.5.1 BINARY's effective selection: its
    placeSeq returns end-start+1 for every candidate (initRootLoglik
    + discarded const loglik() loop, PhyloTreeUnrooted.cpp:916-923
    with INVALID_LOGLIK=1), so all qPlace tie and the winner is
    filterPlacements' front — the best ESTIMATE-stage loglik."""
    start, end = aln.cs_start - 1, aln.cs_end - 1
    locs = get_seed(tree, seq, start, end, max_diff, max_height,
                    max_nseed)
    if not locs:
        return None
    places = estimate_seq(tree, seq, locs, method)
    places = filter_placements(places, max_error)
    est = [p.loglik for p in places]    # estimate-stage logliks
    places = place_seq(tree, seq, places, max_height)
    if ref_rank:
        if not ml_only:
            calc_q_values(tree, places, prior_type)
        from .phylo.placement import _INTROSORT_FRONT
        order = np.argsort(-np.asarray(est), kind="stable")
        rank = _INTROSORT_FRONT[min(len(places),
                                    len(_INTROSORT_FRONT) - 1)]
        return places[int(order[rank])]
    if not ml_only:
        calc_q_values(tree, places, prior_type)
        # reference sorts descending by qPlace and takes the top
        # (hmmufotu.cpp:735-738, compareByQPlace)
        places.sort(key=lambda p: -p.q_place)
        return places[0]
    places.sort(key=lambda p: -p.loglik)
    return places[0]


def assign_batch_device(tree: PTUnrooted, placer, alns,
                        max_diff: float = math.inf,
                        max_height: float = math.inf,
                        max_error: float = DEFAULT_MAX_PLACE_ERROR,
                        prior_type: str = "uniform",
                        ml_only: bool = False, mesh=None):
    """Batched SEP placement of aligned reads through the device placer
    (phylo.placement.DevicePlacer); returns the best PTPlacement per
    read (None for invalid alignments).  Only the packed [B, 12]
    summary is downloaded.

    mesh (parallel.Mesh): place with reads split over its shards
    (parallel.sharded_place_batch), the batch padded to a multiple of
    the mesh size."""
    if mesh is None:
        return collect_place_batch(dispatch_place_batch(
            tree, placer, alns, max_diff, max_height, max_error,
            prior_type, ml_only))
    from .parallel import sharded_place_batch
    B = len(alns)
    seqs, starts, ends, valid = _aln_windows(tree, placer, alns)
    W = placer.W
    Bp = -(-B // mesh.size) * mesh.size
    if Bp != B:
        seqs = np.concatenate([seqs, np.full((Bp - B, W), -2, np.int8)])
        starts = np.concatenate([starts, np.zeros(Bp - B, np.int32)])
        ends = np.concatenate([ends, np.zeros(Bp - B, np.int32)])
    ends = np.minimum(ends, starts + W - 1)
    s = sharded_place_batch(mesh, placer, seqs, starts, ends, max_diff,
                            max_height, max_error, prior_type == "height",
                            ml_only)[:B]
    return _collect_placements(s, valid, starts, ends)


def _aln_windows(tree: PTUnrooted, placer, alns):
    """Digital [B, W] placement windows + coords from alignments."""
    B = len(alns)
    W = placer.W
    seqs = np.full((B, W), -2, dtype=np.int8)
    starts = np.zeros(B, dtype=np.int32)
    ends = np.zeros(B, dtype=np.int32)
    valid = np.zeros(B, dtype=bool)
    bound = placer.start_bound
    for r, aln in enumerate(alns):
        if not aln.is_valid():
            continue
        valid[r] = True
        starts[r] = aln.cs_start - 1
        ends[r] = aln.cs_end - 1
        seqs[r] = aln_to_digital_win(aln, min(int(starts[r]), bound), W)
    return seqs, starts, ends, valid


def _collect_placements(summary, valid, starts, ends):
    """Materialize a [B, 12] placement summary (tensor or numpy) into
    per-read PTPlacement rows."""
    with trace.span("place_wait"):
        s = summary.cpu().numpy() if hasattr(summary, "cpu") \
            else np.asarray(summary)
    results: list[PTPlacement | None] = []
    for r in range(len(valid)):
        if not valid[r] or s[r, 11] == 0:
            results.append(None)
            continue
        results.append(PTPlacement(
            int(starts[r]), int(ends[r]),
            int(s[r, 0]), int(s[r, 1]), int(s[r, 2]),
            float(s[r, 10]), float(s[r, 3]), float(s[r, 4]),
            float(s[r, 5]), float(s[r, 8]),
            float(s[r, 6]), float(s[r, 7])))
    return results


def dispatch_place_batch(tree: PTUnrooted, placer, alns,
                         max_diff: float = math.inf,
                         max_height: float = math.inf,
                         max_error: float = DEFAULT_MAX_PLACE_ERROR,
                         prior_type: str = "uniform",
                         ml_only: bool = False):
    """Enqueue batched SEP placement without waiting for the device;
    returns a handle for collect_place_batch.

    Window-resident placers (DevicePlacer site_window): reads whose
    window falls outside the resident site span go through the exact
    host SEP path (assign_read) instead."""
    seqs, starts, ends, valid = _aln_windows(tree, placer, alns)
    host_rows: dict[int, PTPlacement | None] = {}
    if placer.site_window is not None:
        # the device covers sites [start, min(end, start+W-1)]; route
        # any read whose covered range leaves the resident span
        w0, Wr = placer.site_window
        W = placer.W
        cov_end = np.minimum(ends.astype(np.int64),
                             starts.astype(np.int64) + W - 1)
        oow = valid & ((starts < w0) | (cov_end > w0 + Wr - 1))
        for r in np.nonzero(oow)[0]:
            seq = aln_to_digital(tree, alns[r])
            host_rows[int(r)] = assign_read(
                tree, alns[r], seq, max_diff, max_height, placer.C,
                max_error, prior_type=prior_type, ml_only=ml_only,
                ref_rank=placer.ref_rank)
        # neutralize host-routed rows AND invalid alignments for the
        # device call (invalid rows keep starts=0, which would trip
        # dispatch_win's window check when w0 > 0)
        neut = oow | ~valid
        if neut.any():
            starts = np.where(neut, w0, starts).astype(starts.dtype)
            ends = np.where(neut, w0, ends).astype(ends.dtype)
            seqs[neut] = -2
    out = placer.dispatch_win(seqs, starts, ends, max_diff, max_height,
                              max_error,
                              height_prior=(prior_type == "height"),
                              ml_only=ml_only)
    return out["summary"], valid, starts, ends, host_rows


def collect_place_batch(handle):
    """Wait for and decode a dispatch_place_batch handle."""
    summary, valid, starts, ends, host_rows = handle
    results = _collect_placements(summary, valid, starts, ends)
    for r, p in host_rows.items():
        results[r] = p
    return results


def assign_stream(aligner: ViterbiAligner, csfm: CSFMIndex,
                  tree: PTUnrooted, placer, reads: list[str],
                  batch_size: int = 1024,
                  seed_len: int = DEFAULT_SEED_LEN,
                  seed_region: int = DEFAULT_SEED_REGION,
                  mode: str = GLOBAL,
                  rng: np.random.Generator | None = None,
                  max_diff: float = math.inf,
                  max_height: float = math.inf,
                  max_error: float = DEFAULT_MAX_PLACE_ERROR,
                  prior_type: str = "uniform",
                  ml_only: bool = False):
    """Double-buffered assignment over a read stream.

    Batch k+1's seed search and DP launch run in a worker thread while
    the main thread builds batch k's alignments and enqueues its
    placement; batch k's placement summary is downloaded only after
    batch k+1's host stages.  CUDA launches return before the device
    finishes, so the device work of one batch overlaps the host work of
    the next.

    Yields (alignments, best_placements) per batch, in order.

    Traced (utils.trace): the worker's "dispatch" of batch k; on the
    main thread a "batch" span for batch k holding "wait_seed" (the wait
    for the worker), the aligner's stages, "place_dispatch" and the
    "place_collect" of batch k-1.  No span is open across a yield.
    """
    from concurrent.futures import ThreadPoolExecutor

    batches = [reads[lo:lo + batch_size]
               for lo in range(0, len(reads), batch_size)]

    def dispatch(k):
        with trace.span("dispatch", batch=k):
            vp = batch_find_seed_vpaths(aligner.hmm, csfm, batches[k],
                                        seed_len, seed_region, mode, rng)
            return aligner.dispatch_batch(batches[k], vp)

    def collect(k, handle):
        with trace.span("place_collect", batch=k):
            return collect_place_batch(handle)

    if not batches:
        return
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(dispatch, 0)
        prev = None  # (alns, undecoded placement handle) of batch k-1
        for k in range(len(batches)):
            with trace.span("batch", batch=k):
                with trace.span("wait_seed"):
                    pending = fut.result()
                fut = ex.submit(dispatch, k + 1) \
                    if k + 1 < len(batches) else None
                alns = aligner.finalize_batch(pending)
                with trace.span("place_dispatch"):
                    handle = dispatch_place_batch(tree, placer, alns,
                                                  max_diff, max_height,
                                                  max_error, prior_type,
                                                  ml_only)
                done = None if prev is None else (
                    prev[0], collect(k - 1, prev[1]))
            if done is not None:
                yield done
            prev = (alns, handle)
        if prev is not None:
            yield prev[0], collect(len(batches) - 1, prev[1])


def merge_mp_candidates(tree: PTUnrooted, union: dict, valid, starts,
                        ends, max_diff: float = math.inf,
                        max_height: float = math.inf,
                        max_error: float = DEFAULT_MAX_PLACE_ERROR,
                        prior_type: str = "uniform",
                        ml_only: bool = False, C: int = 50):
    """Exact merge of tree-sharded placement grids, in host numpy.

    union: dict of [B, C * n_shards] candidate grids from
    parallel.sharded_place_batch_tree.  Rebuilds the single-device
    selection from the union of the shards' candidates: the global top-C
    by (p-dist, node id), the max_diff and max_error filters against the
    global bests, the estimate-ranked lane order, then Q values over the
    survivors.  Every per-candidate quantity (estimate, branch lengths,
    loglik) is the same on any shard, so the merge gives the
    single-device result."""
    cand = union["cand"].astype(np.int64)
    # the grids keep the devices' f32 end to end: the single-device path
    # computes Q values in f32, and equal categories (1 - post flushing
    # to 0 gives qPlace 250) need the same rounding
    cd = np.asarray(union["c_dist"])
    est = np.asarray(union["est_loglik"])
    ll = np.asarray(union["loglik"])
    ratio = union["ratio"]
    wnr = union["wnr"]
    w0 = union["w0"]
    live = union["live"] > 0.5
    B = cand.shape[0]
    heights = tree.heights
    parent = np.asarray(tree.parent)

    # global top-C by (dist, node id): two stable argsorts
    cd_s = np.where(np.isfinite(cd), cd, np.inf)
    i2 = np.argsort(cand, axis=1, kind="stable")
    i1 = np.argsort(np.take_along_axis(cd_s, i2, 1), axis=1,
                    kind="stable")
    order = np.take_along_axis(i2, i1, 1)[:, :C]        # [B, C]
    cdo = np.take_along_axis(cd_s, order, 1)

    def take(x):
        return np.take_along_axis(np.asarray(x), order, 1)

    ok = np.isfinite(cdo) & (cdo - cdo[:, :1] <= max_diff)
    e = take(est)
    with np.errstate(invalid="ignore"):
        e_best = np.nanmax(np.where(ok & np.isfinite(e), e, np.nan),
                           axis=1, keepdims=True)
    ok1 = ok & np.isfinite(e) & (e_best - e <= max_error)
    # lanes in estimate rank, as the single-device path orders them
    # before optimizing (take_c in place_batch_device): argmax breaks
    # ties of equal logliks by that order
    sel = np.argsort(np.where(ok1, -e, np.inf), axis=1, kind="stable")
    order = np.take_along_axis(order, sel, 1)
    ok = np.take_along_axis(ok1, sel, 1) \
        & take(live) & np.isfinite(take(ll))

    lls = take(ll)
    c_n = take(cand)
    p_n = parent[c_n]
    rat = take(ratio)
    wn = take(wnr)
    w_0 = take(w0)
    wur = rat * w_0
    height_f = heights[c_n] + wur
    a_is_c = (rat <= 0.5) | (heights[p_n] > max_height)
    a_n = np.where(a_is_c, c_n, p_n)
    anno_place = np.where(a_is_c, wur + wn, (w_0 - wur) + wn)
    if prior_type == "height":
        # placement-only anno dist (PhyloTreeUnrooted.cpp:1166-1177)
        lp = -(anno_place - wn + height_f)
    else:
        lp = np.zeros_like(lls)
    pp = np.where(ok, lls + lp, -np.inf)                # [B, C]
    m = pp.max(axis=1, keepdims=True)
    m_f = np.where(np.isfinite(m), m, 0.0)
    wgt = np.exp(pp - m_f)
    tot = wgt.sum(axis=1, keepdims=True)
    post = wgt / np.maximum(tot, np.finfo(pp.dtype).tiny)
    with np.errstate(divide="ignore"):
        q_place = np.minimum(
            -10.0 * np.log10(np.maximum(1.0 - post, 0.0)), MAX_Q)
    # per-taxon grouping via dense anno ids (same-taxon logsumexp, the
    # ids of DeviceTree.anno_id, kept on the tree after the first batch),
    # in row chunks that bound the [b, C, C] pair tensor
    if getattr(tree, "_anno_ids", None) is None:
        from .phylo.placement import anno_ids
        tree._anno_ids = anno_ids(tree)
    tax = tree._anno_ids[a_n]                           # [B, C]
    lse_all = m_f[:, 0] + np.log(
        np.maximum(tot[:, 0], np.finfo(pp.dtype).tiny))
    q_taxon = np.empty_like(q_place)
    CH = max(1, (1 << 24) // (C * C))
    for b0 in range(0, B, CH):
        b1 = min(b0 + CH, B)
        same = tax[b0:b1, :, None] == tax[b0:b1, None, :]
        pp_pair = np.where(same, pp[b0:b1, None, :], -np.inf)
        mp = pp_pair.max(axis=2)
        mp_f = np.where(np.isfinite(mp), mp, 0.0)
        lse_t = mp_f + np.log(np.maximum(
            np.exp(pp_pair - mp_f[:, :, None]).sum(axis=2),
            np.finfo(pp.dtype).tiny))
        # post_t <= 1; clamp masked lanes (whose lse_t is a tiny-floor
        # artifact) so exp never overflows
        post_t = np.exp(np.minimum(lse_t - lse_all[b0:b1, None], 0.0))
        with np.errstate(divide="ignore"):
            q_taxon[b0:b1] = np.minimum(
                -10.0 * np.log10(np.maximum(1.0 - post_t, 0.0)), MAX_Q)
    score = lls if ml_only else pp
    best = np.argmax(np.where(ok, score, -np.inf), axis=1)  # [B]
    any_ok = ok.any(axis=1)

    def pick(x):
        return np.take_along_axis(x, best[:, None], 1)[:, 0]

    bc, bp, ba = pick(c_n), pick(p_n), pick(a_n)
    bw0, brat, bwn = pick(w_0), pick(rat), pick(wn)
    bll, bh = pick(lls), pick(height_f)
    bqp, bqt = pick(q_place), pick(q_taxon)
    results: list[PTPlacement | None] = []
    for r in range(B):
        if not valid[r] or not any_ok[r]:
            results.append(None)
            continue
        results.append(PTPlacement(
            int(starts[r]), int(ends[r]),
            int(bc[r]), int(bp[r]), int(ba[r]),
            float(bw0[r]), float(brat[r]), float(bwn[r]),
            float(bll[r]), float(bh[r]),
            float(bqp[r]), float(bqt[r])))
    return results


def assign_batch_device_tree(tree: PTUnrooted, placer, alns, mesh,
                             max_diff: float = math.inf,
                             max_height: float = math.inf,
                             max_error: float = DEFAULT_MAX_PLACE_ERROR,
                             prior_type: str = "uniform",
                             ml_only: bool = False):
    """Tree-sharded batched SEP placement: the message tensors split over
    the mesh in node blocks, reads on every shard, the shards' candidate
    grids merged exactly on the host.  Returns the best PTPlacement per
    read, as assign_batch_device."""
    from .parallel import sharded_place_batch_tree
    seqs, starts, ends, valid = _aln_windows(tree, placer, alns)
    union = sharded_place_batch_tree(
        mesh, placer, seqs, starts, ends, max_diff, max_height,
        max_error, prior_type == "height", ml_only)
    return merge_mp_candidates(tree, union, valid, starts, ends,
                               max_diff, max_height, max_error,
                               prior_type, ml_only, placer.C)
