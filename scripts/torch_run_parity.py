#!/usr/bin/env python
"""The port's large-scale oracle parity sweep: scripts/run_parity.py for
hmmufotu_tpu_torch.

Simulated reads go through the port's normal entry points on --device
(default cuda) and through the independent f64 oracle (tests/oracle/,
numpy only, sharing no code with either package), on fresh 70_otus DBs
built by the port's build CLI:

  JC69 single-end (seed 101), GTR+dGamma4 single-end (seed 102) and
  GTR+dGamma4 paired-end (seed 103), -n reads each, and the band
  deviation of the reference's own banded DP against the full DP
  (oracle only, the port's seed search; GTR, seed 104, --band-n reads).

The port's side: the build and sim CLIs; pipeline.align_reads with
ViterbiAligner(hmm, device) (K1); HmmAlignment.merge of the mates;
pipeline.assign_batch_device with DevicePlacer(tree, device=device) (K2
then K3); and the first --host-n single-end reads also through the exact
host path, pipeline.assign_read.  The oracle's half (about 0.6 s a read
on one core) runs in a pool of --jobs processes; the report keeps read
order.

Rules (tests/test_oracle_parity.py, ParityHarness.compare_read and
run_config): the alignment string and coordinates equal (for pairs the
merged string and cs bounds), the cost within 1e-4 relative / 5e-3
absolute; then the same taxon, the same branch or a same-taxon branch
among the oracle's candidates within 0.05 of its qPlace (an f32 tie),
and the loglik within 1e-6 relative / 1e-4 absolute.  A read is counted
under the first of aln, cat, score that it breaks, as run_parity.py
counts it; `edge_differs` counts pairs placed on another edge than the
oracle's at all, run_parity.py's paired-end count.

Prints one JSON line a configuration (n, the counts, seconds, the first
10 details with both costs and both logliks), the JAX package's counts
of PARITY.md beside them, and the card.  Exits 1 when a read aligned as
the oracle aligns it gets another taxon (device or host path), when
more than 1% of a configuration's reads align differently, or when more
than 0.5% of them land on a branch outside the tie rule.

Usage:
    python scripts/torch_run_parity.py [-n 1000] [--band-n 200] [--fast]
        [--device cuda|cpu] [--jobs J] [--host-n 50] [--work DIR]
"""

from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

FIXTURES = os.path.join(REPO, "tests", "fixtures")
CONFIGS = [("JC69", False, False, "JC69-SE", 101),
           ("GTR", True, False, "GTR-dG4-SE", 102),
           ("GTR", True, True, "GTR-dG4-PE", 103)]
BAND_SEED = 104
# the JAX package's counts of the same sweep (PARITY.md, "Large-N parity
# sweep results": scripts/run_parity.py -n 1000 --band-n 200)
JAX_COUNTS = {
    "JC69-SE": dict(n=1000, aln_mismatch=1, cat_mismatch=0,
                    score_mismatch=0),
    "GTR-dG4-SE": dict(n=1000, aln_mismatch=0, cat_mismatch=0,
                       score_mismatch=0),
    "GTR-dG4-PE": dict(n=1000, aln_mismatch=0, cat_mismatch=2,
                       score_mismatch=0),
    "band": dict(n=200, n_banded=139, n_diff_cost=15, n_diff_aln=15,
                 n_diff_cat=1)}
MAX_ALN_FRAC = 0.01         # reads aligned otherwise than the oracle
MAX_BRANCH_FRAC = 0.005     # reads on a branch outside the tie rule
ALN_FIELDS = ("seq_start", "seq_end", "hmm_start", "hmm_end", "cs_start",
              "cs_end")
N_DETAILS = 10


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

def build_db(work: str, model: str, dgamma: bool) -> str:
    """A 70_otus DB through the port's build CLI (numpy f64 engine)."""
    from hmmufotu_tpu_torch.cli.build import main as build_main
    prefix = os.path.join(work, f"70_otus_{model}{'_dG' if dgamma else ''}")
    argv = [os.path.join(FIXTURES, "70_otus.fasta"),
            os.path.join(FIXTURES, "70_otus.tree"),
            "-a", os.path.join(FIXTURES, "70_otus_taxonomy.txt"),
            "-n", prefix, "-s", model] + (["-V"] if dgamma else [])
    if build_main(argv, device="cpu") != 0:
        raise RuntimeError(f"build {model} failed")
    return prefix


def sim_reads(prefix: str, work: str, n: int, seed: int, paired=False):
    """Reads of the port's sim CLI (tests/test_oracle_parity.py's
    arguments); (forward, reverse) for pairs."""
    from hmmufotu_tpu_torch.cli.sim import main as sim_main
    from hmmufotu_tpu_torch.seq import read_seqs
    fwd = os.path.join(work, f"sim_{seed}.fasta")
    rev = os.path.join(work, f"sim_{seed}_R2.fasta")
    argv = [prefix, fwd, "-N", str(n), "-S", str(seed), "--mean-size",
            "300", "--sd-size", "30"] + (["-m", rev] if paired else [])
    if sim_main(argv) != 0:
        raise RuntimeError("sim failed")
    reads = [r.seq for r in read_seqs(fwd)]
    if not paired:
        return reads
    return reads, [r.seq for r in read_seqs(rev)]


class ParityHarness:
    """The port and the oracle over one DB (tests/test_oracle_parity.py's
    harness on the port's Database).  The oracle snapshots the HMM
    before the port's wing_retract()."""

    def __init__(self, db_prefix: str, mode: str, device="cuda"):
        from oracle import RefHmm, RefLocator
        from oracle.ref_phylo import OracleTree
        from hmmufotu_tpu_torch.db import Database
        from hmmufotu_tpu_torch.hmm import ViterbiAligner
        from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
        self.db = Database.load(db_prefix)
        self.mode = mode
        hmm = self.db.hmm
        hmm.set_sequence_mode(mode)
        self.ref_hmm = RefHmm.from_production(hmm)  # pre-retract copy
        hmm.wing_retract()
        self.aligner = ViterbiAligner(hmm, device=device)
        self.locator = RefLocator(self.db.msa)
        self.otree = OracleTree(self.db.ptu)
        self.placer = DevicePlacer(self.db.ptu, device=device)

    # ---- the port ----------------------------------------------------
    def prod_align(self, reads):
        from hmmufotu_tpu_torch import pipeline as pl
        return pl.align_reads(self.aligner, self.db.csfm, reads,
                              mode=self.mode, rng=None)

    def prod_place_host(self, aln):
        from hmmufotu_tpu_torch import pipeline as pl
        seq = pl.aln_to_digital(self.db.ptu, aln)
        return pl.assign_read(self.db.ptu, aln, seq)

    def prod_place_device(self, alns):
        from hmmufotu_tpu_torch import pipeline as pl
        return pl.assign_batch_device(self.db.ptu, self.placer, alns)

    def oracle_state(self):
        """What the oracle's worker processes read."""
        return (self.ref_hmm, self.locator, self.otree, self.mode)


def compare_read(anno, oracle, prod_aln, prod_place) -> list[str]:
    """Mismatch strings (empty = parity) of one single-end read, by the
    rules of tests/test_oracle_parity.py ParityHarness.compare_read;
    `oracle` = the oracle's (alignment, (best, candidates) or None)."""
    o_aln, placed = oracle
    mism = compare_alignment(o_aln, prod_aln)
    if mism:
        return mism  # placement comparison needs matching alignment
    return compare_placement(anno, *placed, prod_place)


def compare_alignment(o_aln, prod_aln) -> list[str]:
    """compare_read's alignment rules: string, coordinates, cost (the
    port's DP runs in f32 on the card, the oracle in f64)."""
    mism = []
    if o_aln.align != prod_aln.align:
        ndiff = sum(a != b for a, b in zip(o_aln.align, prod_aln.align))
        mism.append(f"align str differs at {ndiff} positions")
    for f in ALN_FIELDS:
        if getattr(o_aln, f) != getattr(prod_aln, f):
            mism.append(f"aln.{f}: oracle {getattr(o_aln, f)} "
                        f"prod {getattr(prod_aln, f)}")
    if not math.isclose(o_aln.cost, prod_aln.cost, rel_tol=1e-4,
                        abs_tol=5e-3):
        mism.append(f"cost: oracle {o_aln.cost} prod {prod_aln.cost}")
    return mism


def compare_placement(anno, o_best, o_places, prod_place) -> list[str]:
    """compare_read's placement rules: the taxon; the branch, or a
    same-taxon branch among the oracle's candidates within 0.05 of the
    best's qPlace (an f32-vs-f64 knife-edge tie); the loglik."""
    if prod_place is None:
        return ["prod placement missing"]
    mism = []
    o_tax, p_tax = anno[o_best.a_node], anno[prod_place.a_node]
    if o_tax != p_tax:
        mism.append(f"taxon: oracle {o_tax!r} prod {p_tax!r}")
    if (o_best.c_node, o_best.p_node) != (prod_place.c_node,
                                          prod_place.p_node):
        tie = any(p.c_node == prod_place.c_node
                  and p.p_node == prod_place.p_node
                  and abs(p.q_place - o_best.q_place) < 0.05
                  for p in o_places)
        if not (tie and o_tax == p_tax):
            mism.append(f"branch: oracle {o_best.c_node}->{o_best.p_node} "
                        f"prod {prod_place.c_node}->{prod_place.p_node}")
    if not math.isclose(o_best.loglik, prod_place.loglik, rel_tol=1e-6,
                        abs_tol=1e-4):
        mism.append(f"loglik: oracle {o_best.loglik} "
                    f"prod {prod_place.loglik}")
    return mism


def classify(mism: list[str]) -> str:
    """run_parity.py's counter of a read's mismatches."""
    if any("align" in m or "aln." in m or "cost" in m or "merged" in m
           for m in mism):
        return "aln_mismatch"
    if any("taxon" in m or "branch" in m for m in mism):
        return "cat_mismatch"
    return "score_mismatch"


def merge_mates(a, b):
    """run_config's merge: the mate fills the forward read's pads when
    the pair is oriented."""
    if a.cs_start <= b.cs_start and a.cs_end <= b.cs_end:
        a.merge(b)
    return a


# ---------------------------------------------------------------------------
# the oracle's side, in worker processes (numpy only)
# ---------------------------------------------------------------------------

_ORACLE = None


def _init_worker(state):
    global _ORACLE
    _ORACLE = state


class _Cand:
    """The fields of an oracle placement that the rules read."""
    __slots__ = ("c_node", "p_node", "a_node", "q_place", "loglik")

    def __init__(self, p):
        for k in self.__slots__:
            setattr(self, k, getattr(p, k))


def _place_all(otree, aln):
    from oracle.ref_phylo import oracle_assign_read
    from hmmufotu_tpu_torch.alphabet import DNA
    best, places = oracle_assign_read(otree, DNA.encode_upper(aln.align),
                                      aln.cs_start - 1, aln.cs_end - 1)
    return _Cand(best), [_Cand(p) for p in places]


def _oracle_read(task):
    """(alignment, (best, candidates) or None) of one read or pair; the
    placement only where the oracle's alignment string is the port's."""
    from oracle import oracle_align_seq
    ref_hmm, locator, otree, mode = _ORACLE
    reads, want = task
    alns = [oracle_align_seq(ref_hmm, locator, r, mode=mode) for r in reads]
    o_aln = alns[0] if len(alns) == 1 else merge_mates(*alns)
    placed = _place_all(otree, o_aln) if o_aln.align == want else None
    return o_aln, placed


def _band_read(task):
    """The reference's banded DP against its full DP on one read
    (oracle only): (banded, cost gap, alignment differs, taxon
    differs)."""
    from oracle.ref_hmm import OracleVPath, OracleVScores
    ref_hmm, _, otree, _ = _ORACLE
    read, vps = task
    if not vps:
        return False, 0.0, False, False
    ovp = [OracleVPath(*v) for v in vps]
    enc = ref_hmm.encode(read)
    vsb = OracleVScores(ref_hmm.K, len(read))
    ref_hmm.calc_viterbi_scores_banded(enc, vsb, ovp)
    vtb = ref_hmm.build_viterbi_trace(vsb)
    if vtb.min_score == math.inf:
        return False, 0.0, False, False
    vsf = OracleVScores(ref_hmm.K, len(read))
    ref_hmm.calc_viterbi_scores_full(enc, vsf)
    vtf = ref_hmm.build_viterbi_trace(vsf)
    gap = vtb.min_score - vtf.min_score
    diff_aln = diff_cat = False
    if gap > 1e-9:
        ab = ref_hmm.build_global_align(read, vsb, vtb)
        af = ref_hmm.build_global_align(read, vsf, vtf)
        if ab.align != af.align:
            diff_aln = True
            bb = _place_all(otree, ab)[0]
            bf = _place_all(otree, af)[0]
            diff_cat = otree.anno[bb.a_node] != otree.anno[bf.a_node]
    return True, gap, diff_aln, diff_cat


def oracle_map(fn, state, tasks, jobs: int) -> list:
    """fn over tasks in read order: in `jobs` spawned processes (fresh
    interpreters, numpy and the oracle only), or here when jobs <= 1."""
    if jobs <= 1 or len(tasks) <= 1:
        _init_worker(state)
        return [fn(t) for t in tasks]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(jobs, len(tasks)), initializer=_init_worker,
                  initargs=(state,)) as pool:
        return pool.map(fn, tasks, chunksize=max(1, len(tasks)
                                                 // (8 * jobs)))


# ---------------------------------------------------------------------------
# the sweeps
# ---------------------------------------------------------------------------

def run_sweep(work, model, dgamma, n_reads, seed, paired, tag,
              device="cuda", jobs=1, host_n=0, prefix=None) -> dict:
    """One configuration: the port on `device`, the oracle in `jobs`
    processes; the counts, seconds and first details.  `prefix`: a DB
    of `model` already built by build_db, else one is built."""
    from hmmufotu_tpu_torch.alphabet import DNA
    from hmmufotu_tpu_torch.hmm import GLOBAL, NGCL
    d = os.path.join(work, f"{tag}_{seed}")
    os.makedirs(d, exist_ok=True)
    t0 = time.time()
    prefix = prefix or build_db(d, model, dgamma)
    h = ParityHarness(prefix, GLOBAL if paired else NGCL, device)
    stats = dict(tag=tag, n=n_reads, aln_mismatch=0, cat_mismatch=0,
                 score_mismatch=0, taxon_mismatch=0, branch_outside_tie=0,
                 edge_differs=0, host_n=0, host_taxon_mismatch=0,
                 host_branch_mismatch=0, details=[], edge_details=[])
    if paired:
        fwd, rev = sim_reads(prefix, d, n_reads, seed, paired=True)
        rev_rc = [DNA.revcom(r) for r in rev]
        t_build = time.time() - t0
        t = time.time()
        alns = [merge_mates(a, b) for a, b in
                zip(h.prod_align(fwd), h.prod_align(rev_rc))]
        places = h.prod_place_device(alns)
        tasks = [((f, r), a.align) for f, r, a in zip(fwd, rev_rc, alns)]
    else:
        reads = sim_reads(prefix, d, n_reads, seed)
        t_build = time.time() - t0
        t = time.time()
        alns = h.prod_align(reads)
        places = h.prod_place_device(alns)
        tasks = [((r,), a.align) for r, a in zip(reads, alns)]
    if device != "cpu":
        import torch
        torch.cuda.synchronize()
    t_port = time.time() - t
    t = time.time()
    oracle = oracle_map(_oracle_read, h.oracle_state(), tasks, jobs)
    t_oracle = time.time() - t
    anno = h.db.ptu.anno
    for r, ((o_aln, placed), aln, place) in enumerate(
            zip(oracle, alns, places)):
        if paired:
            # run_config's paired rules: the merged string and cs bounds
            mism = []
            if o_aln.align != aln.align:
                mism.append("merged align differs")
            if (o_aln.cs_start, o_aln.cs_end) != (aln.cs_start, aln.cs_end):
                mism.append("merged cs bounds differ")
            if not mism and place is not None:
                mism = compare_placement(anno, *placed, place)
                o = placed[0]
                if (o.c_node, o.p_node) != (place.c_node, place.p_node):
                    stats["edge_differs"] += 1
                    stats["edge_details"].append(dict(
                        read=r, oracle=f"{o.c_node}->{o.p_node}",
                        port=f"{place.c_node}->{place.p_node}",
                        loglik=[o.loglik, place.loglik],
                        q_place=[o.q_place, place.q_place],
                        taxon=[anno[o.a_node], anno[place.a_node]]))
        else:
            mism = compare_read(anno, (o_aln, placed), aln, place)
        if mism:
            stats[classify(mism)] += 1
            stats["taxon_mismatch"] += any("taxon" in m for m in mism)
            stats["branch_outside_tie"] += any("branch" in m for m in mism)
            if len(stats["details"]) < N_DETAILS:
                stats["details"].append(dict(
                    read=r, mism=mism, cost=[o_aln.cost, aln.cost],
                    loglik=[placed[0].loglik if placed else None,
                            place.loglik if place else None]))
    t = time.time()
    if not paired:
        for r in range(min(host_n, n_reads)):
            o_aln, placed = oracle[r]
            if placed is None or compare_alignment(o_aln, alns[r]):
                continue
            host = h.prod_place_host(alns[r])
            stats["host_n"] += 1
            stats["host_taxon_mismatch"] += anno[host.a_node] != \
                anno[placed[0].a_node]
            stats["host_branch_mismatch"] += (host.c_node, host.p_node) != \
                (placed[0].c_node, placed[0].p_node)
    stats.update(build_sim_s=t_build, port_s=t_port, oracle_s=t_oracle,
                 host_s=time.time() - t, secs=time.time() - t0)
    return stats


def run_band_deviation(work, n_reads, seed, device="cuda", jobs=1) -> dict:
    """The reference's own banded-vs-full deviation (the band is a
    heuristic): the port's seed paths, the oracle's two DPs."""
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch.hmm import NGCL
    d = os.path.join(work, "band")
    os.makedirs(d, exist_ok=True)
    t0 = time.time()
    prefix = build_db(d, "GTR", False)
    h = ParityHarness(prefix, NGCL, device)
    reads = sim_reads(prefix, d, n_reads, seed)
    vps = pl.batch_find_seed_vpaths(h.aligner.hmm, h.db.csfm, reads,
                                    mode=NGCL, rng=None)
    tasks = [(read, [(v.start, v.end, v.from_, v.to, v.n_ins, v.n_del)
                     for v in vp]) for read, vp in zip(reads, vps)]
    res = oracle_map(_band_read, h.oracle_state(), tasks, jobs)
    gaps = [g for b, g, _, _ in res if b and g > 1e-9]
    return dict(n=n_reads, n_banded=sum(b for b, _, _, _ in res),
                n_diff_cost=len(gaps), n_diff_aln=sum(r[2] for r in res),
                n_diff_cat=sum(r[3] for r in res),
                max_cost_gap=max(gaps, default=0.0),
                secs=time.time() - t0)


def jax_counted(stats: dict) -> dict:
    """A configuration's counts as run_parity.py counts them: for pairs it
    checks no score and counts every pair off the oracle's edge."""
    if stats["tag"].endswith("PE"):
        return dict(n=stats["n"], aln_mismatch=stats["aln_mismatch"],
                    cat_mismatch=stats["edge_differs"], score_mismatch=0)
    return {k: stats[k] for k in ("n", "aln_mismatch", "cat_mismatch",
                                  "score_mismatch")}


def failures(stats: dict) -> list[str]:
    """The exit-1 rules of one configuration."""
    n, out = stats["n"], []
    if stats["taxon_mismatch"] or stats["host_taxon_mismatch"]:
        out.append(f"{stats['tag']}: a read aligned as the oracle aligns "
                   f"it got another taxon")
    if stats["aln_mismatch"] > MAX_ALN_FRAC * n:
        out.append(f"{stats['tag']}: {stats['aln_mismatch']} of {n} "
                   f"alignments differ (> {MAX_ALN_FRAC:.1%})")
    if stats["branch_outside_tie"] > MAX_BRANCH_FRAC * n:
        out.append(f"{stats['tag']}: {stats['branch_outside_tie']} of {n} "
                   f"branches outside the tie rule "
                   f"(> {MAX_BRANCH_FRAC:.1%})")
    return out


# ---------------------------------------------------------------------------
# the oracle's goldens through the port's CLIs
# ---------------------------------------------------------------------------

def _body(path):
    with open(path) as fh:
        return [line.rstrip("\n").split("\t") for line in fh
                if not line.startswith("#") and not line.startswith("id\t")]


def _golden_db(work, extra=()):
    from hmmufotu_tpu_torch.cli.build import main as build_main
    db = os.path.join(work, "gdb")
    if build_main([os.path.join(FIXTURES, "70_otus.fasta"),
                   os.path.join(FIXTURES, "70_otus.tree"),
                   "-a", os.path.join(FIXTURES, "70_otus_taxonomy.txt"),
                   "-n", db, "-s", "GTR", *extra], device="cpu") != 0:
        raise RuntimeError("golden DB build failed")
    return db


def golden_assign(work: str, device="cuda") -> dict:
    """tests/golden_assign_categories.tsv through the port's build, sim
    and assign CLIs (GTR, sim -N 40 -S 0, assign without -S): each read's
    taxon equal to the oracle's, its branch in the oracle's tie set
    (tests/test_pipeline.py TestGoldenCategories).  Returns the golden's
    and the output's row counts and the failures."""
    from hmmufotu_tpu_torch.cli.assign import main as assign_main
    from hmmufotu_tpu_torch.cli.sim import main as sim_main
    os.makedirs(work, exist_ok=True)
    db = _golden_db(work)
    reads, out = os.path.join(work, "r.fasta"), os.path.join(work, "a.tsv")
    if sim_main([db, reads, "-N", "40", "-S", "0", "--mean-size", "300",
                 "--sd-size", "20"]) != 0:
        raise RuntimeError("sim failed")
    if assign_main([db, reads, "-o", out], device=device) != 0:
        raise RuntimeError(f"assign on {device} failed")
    got = {f[0]: (f[10], f[12]) for f in _body(out)}
    fails, n = [], 0
    for rid, _, taxon, ties in _body(os.path.join(
            REPO, "tests", "golden_assign_categories.tsv")):
        n += 1
        if rid not in got:
            fails.append((rid, "missing"))
        elif got[rid][1] != taxon or got[rid][0] not in ties.split(","):
            fails.append((rid, got[rid], taxon, ties))
    return dict(n=n, rows=len(got), failures=fails)


def golden_jplace(work: str, device="cuda") -> dict:
    """tests/golden_jplace_pe.tsv through the port's build (GTR -V), sim
    (-m, -N 20 -S 5), assign (pairs) and jplace CLIs: each pair's edge
    id exact, its likelihood within max(0.05, 1e-5 |ll|) (the TSV's %g
    loglik), distal and pendant lengths within 1e-4
    (tests/test_pipeline.py TestGoldenCategories)."""
    from hmmufotu_tpu_torch.cli.assign import main as assign_main
    from hmmufotu_tpu_torch.cli.jplace import main as jplace_main
    from hmmufotu_tpu_torch.cli.sim import main as sim_main
    os.makedirs(work, exist_ok=True)
    db = _golden_db(work, ["-V"])
    r1, r2 = os.path.join(work, "r1.fasta"), os.path.join(work, "r2.fasta")
    tsv, jp = os.path.join(work, "a.tsv"), os.path.join(work, "a.jplace")
    if sim_main([db, r1, "-m", r2, "-N", "20", "-S", "5", "--mean-size",
                 "300", "--sd-size", "20"]) != 0:
        raise RuntimeError("sim failed")
    if assign_main([db, r1, r2, "-o", tsv], device=device) != 0:
        raise RuntimeError(f"assign on {device} failed")
    if jplace_main([db, tsv, "-o", jp]) != 0:
        raise RuntimeError("jplace failed")
    with open(jp) as fh:
        doc = json.load(fh)
    idx = [doc["fields"].index(k) for k in
           ("edge_num", "likelihood", "distal_length", "pendant_length")]
    got = {}
    for row in doc["placements"]:
        name = row.get("n", row.get("nm"))[0]
        name = name[0] if isinstance(name, list) else name
        got[name] = [row["p"][0][i] for i in idx]
    fails, n = [], 0
    for f in _body(os.path.join(REPO, "tests", "golden_jplace_pe.tsv")):
        n += 1
        name, edge = f[0], int(f[1])
        like, dist, pend = float(f[3]), float(f[4]), float(f[5])
        g = got.get(name)
        if g is None:
            fails.append((name, "missing"))
        elif (g[0] != edge or abs(g[1] - like) > max(0.05, 1e-5 * abs(like))
              or abs(g[2] - dist) > 1e-4 or abs(g[3] - pend) > 1e-4):
            fails.append((name, g, [edge, like, dist, pend]))
    return dict(n=n, rows=len(got), failures=fails)


def card_line(device) -> str | None:
    """nvidia-smi's name and power limit of the card, None on the CPU."""
    import torch
    if torch.device(device).type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", type=int, default=1000,
                    help="reads per configuration")
    ap.add_argument("--band-n", type=int, default=200,
                    help="reads for the band-deviation sweep")
    ap.add_argument("--fast", action="store_true",
                    help="50 reads per config (smoke)")
    ap.add_argument("--device", default="cuda",
                    help="the port's device (cuda, or cpu)")
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1,
                    help="oracle processes")
    ap.add_argument("--host-n", type=int, default=50,
                    help="single-end reads also through the host path")
    ap.add_argument("--work", default=os.path.join(REPO, ".bench",
                                                   "torch_parity"),
                    help="directory of the DBs and reads")
    args = ap.parse_args(argv)
    from hmmufotu_tpu_torch._cuda import resolve_device
    device = str(resolve_device(args.device))
    n = 50 if args.fast else args.n
    bn = 50 if args.fast else args.band_n
    os.makedirs(args.work, exist_ok=True)
    card = card_line(device)
    results = []
    for model, dg, paired, tag, seed in CONFIGS:
        print(f"== {tag}: {n} reads ==", flush=True)
        results.append(run_sweep(args.work, model, dg, n, seed, paired,
                                 tag, device, args.jobs, args.host_n))
        print(json.dumps(results[-1]), flush=True)
    print(f"== band deviation: {bn} reads ==", flush=True)
    band = run_band_deviation(args.work, bn, BAND_SEED, device, args.jobs)
    print(json.dumps(dict(tag="band", **band)), flush=True)
    print(json.dumps({"port_vs_jax": {
        s["tag"]: {"port": jax_counted(s), "jax": JAX_COUNTS[s["tag"]]}
        for s in results} | {
        "band": {"port": {k: band[k] for k in JAX_COUNTS["band"]},
                 "jax": JAX_COUNTS["band"]}},
        "jax_source": "PARITY.md, scripts/run_parity.py -n 1000 "
                      "--band-n 200"}), flush=True)
    print(f"card: {card}", flush=True)
    bad = [f for s in results for f in failures(s)]
    for f in bad:
        print(f"FAIL {f}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
