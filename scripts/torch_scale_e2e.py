"""The PyTorch port's end-to-end assignment at the gg_97 shape.

Counterpart of scripts/scale_e2e.py on hmmufotu_tpu_torch: raw 250 bp
read strings flow through pipeline.assign_stream, the double-buffered
path of the assign CLI, at the reference database's shape (149,999 nodes
x 6,000 columns at --leaves 75000 --length 6000):

  CSFM seed lookup over the leaves' concatenation (host)
    -> banded Viterbi DP with in-kernel traceback at K ~ 6,000 (K1)
    -> alignment strings (host)
    -> window-resident SEP placement (K2, K3) and Q values (card);
       with --whole-tree every column is evaluated and the whole tree's
       messages stay on the card (the assign CLI's default placer), and
       no read goes to the exact host path.

The CSFM index, the profile HMM and the evaluated message window are
cached under --cache (default .bench/torch_scale_cache, gitignored; file
names torch_csfm_*, torch_hmm_*, torch_msgs_*).  After a warm-up stream,
--repeat R streams of the same read set are timed in one process; the
aligner's stage clocks (hmm.viterbi.TIMING, HMMUFOTU_TIMING) give the
substages, and host clocks the seed search and the exact host path, as
a mean per stream.  Reads placed by the exact host path
(alignments leaving the resident window) are counted.  The first
--parity reads are held against the exact host SEP path
(pipeline.assign_read) on the same alignments: strictly (the same
c_node, parity_cnode_exact); as the JAX script counts them (the same
c_node, or the host's pick better than the device's by at most 8 f32
ulps of its loglik, parity_cnode_match); and by the device's best
loglik within 8 ulps of the host's either way (parity_loglik_match).
Under --whole-tree the reads of the last timed stream whose placement
window leaves the span (those the window-resident placer sends to the
exact host path) are held against that path too (parity_oow_*).  The
run fails when fewer than 95% agree by either of the last two.  The
JAX script's count alone cannot tell a lower precision: bf16 message
storage passes it, while its logliks stray from the host's by tens of
nats and more.

--paired runs BASELINE config #4 instead: --reads pairs of 2 x
--read-len mates, each from one leaf fragment of the sim CLI's size
(N(500, 30^2) columns) inside the span, through the assign CLI's own
batch loop (cli.assign.batch_loop: both mates aligned in GLOBAL mode,
the orientation test and merge on the host, the merged reads placed on
the device; implies --whole-tree), --repeat timed passes after a
warm-up, with host clocks of its stages.  The first --parity pairs are
held against the exact host path on the merged alignment clipped to the
columns the device scores (clip_to_device_window; the run fails under
95% by either rule) and, reported only, on the whole merged alignment.
--mesh runs the passes again over parallel.make_mesh() (every local
card; eight CPU shards on the CPU) and fails unless every row equals
the passes' without it bit for bit.

    python scripts/torch_scale_e2e.py --leaves 75000 --length 6000 \
        --reads 20480 --batch 2048 --repeat 3 [--msg-dtype bf16] \
        [--whole-tree | --paired [--mesh]]
CPU smoke:
    python scripts/torch_scale_e2e.py --leaves 300 --length 1200 \
        --reads 64 --batch 32 --parity 16 --repeat 2 --device cpu \
        [--whole-tree | --paired [--mesh]]

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_scale_assign import (db_resident_gb, load_tree_model,  # noqa
                                profile_window, simulate_window_reads,
                                site_window, window_messages)
from torch_scale_eval import (card_line, device_peak_gb,  # noqa: E402
                              peak_rss_gb, synth_tree)


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def build_index_and_hmm(tree, leaves, args, res):
    """(CSFM index, profile HMM) of the tree's leaf sequences, from the
    cache where it holds them."""
    from hmmufotu_tpu_torch.hmm import ProfileHMM
    from hmmufotu_tpu_torch.index import CSFMIndex
    from hmmufotu_tpu_torch.mathx.dirichlet import HmmPrior
    from hmmufotu_tpu_torch.msa import MSA
    key = f"{args.leaves}_{args.length}_{args.seed}"
    csfm_cache = hmm_cache = ""
    if args.cache:
        os.makedirs(args.cache, exist_ok=True)
        csfm_cache = os.path.join(args.cache, f"torch_csfm_{key}.npz")
        hmm_cache = os.path.join(args.cache, f"torch_hmm_{key}.hmm")
    lut = np.full(256, ord("-"), np.uint8)
    lut[:4] = np.frombuffer(b"ACGT", np.uint8)
    chars = lut[np.clip(tree.seqs[leaves], -2, 3).astype(np.int16) % 256]
    names = [tree.names[int(u)] for u in leaves]
    msa = MSA.from_arrays(names, chars, name="synth")
    tree.msa_id[leaves] = np.arange(len(leaves))
    del chars

    t0 = time.perf_counter()
    log("csfm...")
    if csfm_cache and os.path.exists(csfm_cache):
        csfm = CSFMIndex.load(csfm_cache)
        res["csfm_cached"] = True
    else:
        csfm = CSFMIndex.build(msa)
        if csfm_cache:
            csfm.save(csfm_cache)
    res["t_csfm_s"] = time.perf_counter() - t0
    res["csfm_chars"] = int(csfm.concat_len)

    t0 = time.perf_counter()
    log("hmm...")
    if hmm_cache and os.path.exists(hmm_cache):
        hmm = ProfileHMM.from_hmmer_file(hmm_cache)
        res["hmm_cached"] = True
    else:
        prior = HmmPrior.load(os.path.join(
            REPO, "hmmufotu_tpu_torch", "data", "gg_97_otus.dm"))
        hmm = ProfileHMM.build(msa, 0.5, prior, name="synth")
        if hmm_cache:
            hmm.to_hmmer_file(hmm_cache)
    res["t_hmm_s"] = time.perf_counter() - t0
    res["K"] = hmm.K
    return csfm, hmm


def host_placements(pl, tree, alns, best, rows, args) -> dict:
    """{row: the exact host SEP path's best placement (pipeline.assign_read,
    None where it places nothing)} of the rows of `rows` that the device
    placed, on the same alignments."""
    out = {}
    for r in rows:
        if best[r] is not None and alns[r].is_valid():
            seq = pl.aln_to_digital(tree, alns[r])
            out[r] = pl.assign_read(tree, alns[r], seq,
                                    max_nseed=args.max_nseed)
    return out


def agreement(best, host, spans, W, log_as) -> dict:
    """The device's best placements against the host's ({row: placement}
    of host_placements) on the rows both placed: the counts of the
    module docstring's three rules, the same taxon (a node), and the
    largest loglik gap; spans[r] is row r's aligned width in columns, of
    which the device scores at most W."""
    n_exact = n_match = n_ll = n_both = n_trunc = n_trunc_mism = 0
    n_trunc_ll = n_taxon = 0
    max_dll = 0.0
    for r, h in host.items():
        if best[r] is None or h is None:
            continue
        n_both += 1
        span = spans[r]
        trunc = span > W       # the device clamps the region to W cols
        n_trunc += int(trunc)
        ulp = abs(h.loglik) * 2.0 ** -23
        dll = abs(h.loglik - best[r].loglik)
        max_dll = max(max_dll, dll)
        n_ll += int(dll <= 8 * ulp)
        n_trunc_ll += int(trunc and dll <= 8 * ulp)
        n_taxon += int(best[r].a_node == h.a_node)
        if dll > 8 * ulp:
            log(f"{log_as} loglik apart r{r}: dev {best[r].loglik:.1f} "
                f"host {h.loglik:.1f} span {span}"
                + (" TRUNCATED" if trunc else ""))
        if best[r].c_node == h.c_node:
            n_exact += 1
            n_match += 1
        else:
            # the synthetic tree's random leaves make window logliks
            # large; candidates within a few f32 ulps of each other flip
            # between the device's and the host's summation orders
            if h.loglik - best[r].loglik <= 8 * ulp:
                n_match += 1
            else:
                n_trunc_mism += int(trunc)
                log(f"{log_as} mismatch r{r}: dev {best[r].c_node} "
                    f"(ll {best[r].loglik:.1f}) host {h.c_node} "
                    f"(ll {h.loglik:.1f}) span {span}"
                    + (" TRUNCATED" if trunc else ""))
    return {"reads": int(n_both), "cnode_exact": int(n_exact),
            "cnode_match": int(n_match), "loglik_match": int(n_ll),
            "taxon_match": int(n_taxon),
            "max_abs_dloglik": float(max_dll),
            "span_gt_W": int(n_trunc), "mism_span_gt_W": int(n_trunc_mism),
            "loglik_match_span_gt_W": int(n_trunc_ll)}


def aln_span(aln) -> int:
    return aln.cs_end - aln.cs_start + 1


def host_agreement(pl, tree, alns, best, rows, W, args, log_as):
    """The device's best placements of `rows` against the exact host SEP
    path on the same alignments (agreement's counts)."""
    return agreement(best, host_placements(pl, tree, alns, best, rows,
                                           args),
                     [aln_span(a) for a in alns], W, log_as)


def parity(pl, aligner, csfm, tree, placer, reads, leaf_ids, args, GLOBAL):
    """The first --parity reads through assign_stream against the exact
    host SEP path on the same alignments."""
    P = min(args.parity, len(reads))
    sub = reads[:max(P, args.batch)]
    alns, best = [], []
    for a, b in pl.assign_stream(aligner, csfm, tree, placer, sub,
                                 args.batch, mode=GLOBAL,
                                 rng=np.random.default_rng(2)):
        alns.extend(a)
        best.extend(b)
    t0 = time.perf_counter()
    got = host_agreement(pl, tree, alns, best, range(P), placer.W, args,
                         "parity")
    out = {"t_parity_s": time.perf_counter() - t0}
    out.update({"parity_" + k: v for k, v in got.items()})
    out["dev_hits_true_leaf"] = int(sum(
        b is not None and b.c_node == leaf_ids[r]
        for r, b in enumerate(best[:P])))
    return out


def leaves_window(st: int, en: int, s_lo: int, Ws: int, W: int) -> bool:
    """Whether the placement window of a read aligned on 0-based columns
    [st, en] leaves the resident site window [s_lo, s_lo + Ws): the rule
    by which pipeline.dispatch_place_batch sends a read to the exact host
    path (the device covers [st, min(en, st + W - 1)])."""
    return st < s_lo or min(en, st + W - 1) > s_lo + Ws - 1


def out_of_window(alns, s_lo, Ws, W) -> list[int]:
    """Rows of valid alignments whose placement window leaves [s_lo,
    s_lo + Ws)."""
    return [r for r, a in enumerate(alns) if a.is_valid() and leaves_window(
        a.cs_start - 1, a.cs_end - 1, s_lo, Ws, W)]


# ---------------------------------------------------------------------------
# --paired: BASELINE config #4, 2 x 250 bp mates through the CLI's batch loop
# ---------------------------------------------------------------------------

def simulate_pairs(tree, n, s_lo, s_hi, read_len, rng, mean, sd):
    """[n] read pairs of 2 x read_len bases from leaf fragments inside CS
    columns [s_lo, s_hi).  A fragment is round(N(mean, sd^2)) columns of
    one leaf (the reference sim's fragment size, in columns), its gaps
    dropped and 2% of its bases substituted as simulate_window_reads
    does; the forward mate is its first read_len bases, the reverse mate
    the reverse complement of its last read_len.  Returns (fwd, rev,
    cols [n, 2] 0-based first and last column of the fragment's bases,
    leaf_ids)."""
    from hmmufotu_tpu_torch.alphabet import DNA
    from hmmufotu_tpu_torch.seq import PrimarySeq
    leaves = np.nonzero(tree.has_seq)[0]
    acgt = np.frombuffer(b"ACGT", np.uint8)
    fwd, rev = [], []
    cols = np.zeros((n, 2), np.int64)
    leaf_ids = np.zeros(n, np.int64)
    for r in range(n):
        while True:
            u = int(leaves[rng.integers(len(leaves))])
            ln = int(round(rng.normal(mean, sd)))
            ln = min(max(ln, read_len), s_hi - s_lo)
            c0 = s_lo + int(rng.integers(0, s_hi - s_lo - ln + 1))
            codes = tree.seqs[u, c0:c0 + ln]
            pos = np.nonzero(codes >= 0)[0]
            if len(pos) >= read_len:
                break
        piece = codes[pos].copy()
        mut = rng.random(len(piece)) < 0.02
        piece[mut] = rng.integers(0, 4, int(mut.sum()), dtype=np.int8)
        frag = acgt[piece].tobytes().decode()
        cols[r] = c0 + pos[0], c0 + pos[-1]
        leaf_ids[r] = u
        desc = f"leaf={u};csStart={cols[r, 0]};csEnd={cols[r, 1]};"
        fwd.append(PrimarySeq(f"p{r}", frag[:read_len], desc))
        rev.append(PrimarySeq(f"p{r}", DNA.revcom(frag[-read_len:]), desc))
    return fwd, rev, cols, leaf_ids


def clip_to_device_window(aln, W: int):
    """The merged alignment as the device placer scores it: a copy whose
    string is pad '.' outside the 0-based columns [start, min(end,
    start + W - 1)], with cs_end set to match (DevicePlacer.dispatch_win
    clamps each read's end so).  An alignment of at most W columns, or
    an invalid one, is returned as it is."""
    import copy
    if not aln.is_valid() or aln_span(aln) <= W:
        return aln
    st = aln.cs_start - 1
    en = st + W - 1
    out = copy.copy(aln)
    out.align = ("." * st + aln.align[st:en + 1]
                 + "." * (len(aln.align) - en - 1))
    out.cs_end = en + 1
    return out


class LoopClock:
    """Host clocks of the CLI's batch loop, from wrappers of the pipeline
    functions it calls (the loop itself is not touched): the seed search
    (batch_find_seed_vpaths), the alignment of the reads and of the mates
    (align_reads, the seed search in it), the orientation test and merge
    (from the mates' alignment to the placement call), the placement
    (assign_batch_device, results on the host) and the TSV rows (from the
    placement to the next batch's alignment, or the pass's end).  Each
    placement call's merged alignments and best placements are kept in
    `calls`."""

    KEYS = ("seed_search", "align", "merge_orient", "placement", "tsv")

    def __init__(self, pl):
        self.pl = pl
        self.orig = {k: getattr(pl, k) for k in (
            "batch_find_seed_vpaths", "align_reads", "assign_batch_device")}
        self.s = dict.fromkeys(self.KEYS, 0.0)
        self.after_align = self.after_place = None
        self.calls = []

    def __enter__(self):
        pl, orig, s = self.pl, self.orig, self.s

        def seed(*a, **kw):
            t = time.perf_counter()
            try:
                return orig["batch_find_seed_vpaths"](*a, **kw)
            finally:
                s["seed_search"] += time.perf_counter() - t

        def align(*a, **kw):
            t = time.perf_counter()
            if self.after_place is not None:
                s["tsv"] += t - self.after_place
                self.after_place = None
            out = orig["align_reads"](*a, **kw)
            self.after_align = time.perf_counter()
            s["align"] += self.after_align - t
            return out

        def place(tree, placer, alns, *a, **kw):
            t = time.perf_counter()
            s["merge_orient"] += t - self.after_align
            best = orig["assign_batch_device"](tree, placer, alns, *a, **kw)
            self.after_place = time.perf_counter()
            s["placement"] += self.after_place - t
            self.calls.append((list(alns), best))
            return best

        pl.batch_find_seed_vpaths = seed
        pl.align_reads = align
        pl.assign_batch_device = place
        return self

    def end_pass(self):
        if self.after_place is not None:
            self.s["tsv"] += time.perf_counter() - self.after_place
            self.after_place = None

    def reset(self):
        self.s.update(dict.fromkeys(self.KEYS, 0.0))
        self.calls = []

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(self.pl, k, fn)


class ShardClock:
    """Per-card device time of the placement: CUDA events on the current
    stream of each call's card around every place_batch_device (a
    sharded batch calls it once a shard, each on its shard's card), and
    the host seconds each call took to enqueue.  Events on different
    cards cannot be compared, so whether the shards overlap shows from
    the sum of the cards' busy time against the placement's host time."""

    def __init__(self, cuda: bool):
        from hmmufotu_tpu_torch.phylo import placement
        self.mod, self.cuda = placement, cuda
        self.orig = placement.place_batch_device
        self.events, self.enqueue_s = {}, {}

    def __enter__(self):
        import torch

        def wrapped(dt, seq_win, *a, **kw):
            d = seq_win.device
            key = str(d)
            ev = None
            if self.cuda:
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(2)]
                ev[0].record(torch.cuda.current_stream(d))
            t = time.perf_counter()
            out = self.orig(dt, seq_win, *a, **kw)
            self.enqueue_s[key] = self.enqueue_s.get(key, 0.0) \
                + time.perf_counter() - t
            if ev is not None:
                ev[1].record(torch.cuda.current_stream(d))
                self.events.setdefault(key, []).append(ev)
            return out

        self.mod.place_batch_device = wrapped
        return self

    def busy_ms(self) -> dict:
        """{card: ms between each call's two events, summed}; waits for
        the cards."""
        import torch
        out = {}
        for key, evs in self.events.items():
            torch.cuda.synchronize(torch.device(key))
            out[key] = sum(a.elapsed_time(b) for a, b in evs)
        return out

    def reset(self):
        self.events, self.enqueue_s = {}, {}

    def __exit__(self, *exc):
        self.mod.place_batch_device = self.orig


def placement_rows(calls) -> tuple[list, list]:
    """(merged alignments, best placements) of a pass, in pair order."""
    alns, best = [], []
    for a, b in calls:
        alns.extend(a)
        best.extend(b)
    return alns, best


def exact_rows(best) -> list[str]:
    """Each best placement's fields but its window, exactly (repr
    round-trips a float).  The window's end is left out: a placement made
    over a mesh carries the end clamped to W columns, one made without it
    the aligned end, in both packages (pipeline.assign_batch_device), and
    the TSV prints neither."""
    return [repr(None if b is None else sorted(
        (k, v) for k, v in vars(b).items() if k not in ("start", "end")))
        for b in best]


def paired_run(args, res, pl, tree, csfm, aligner, placer, dev, fwd, rev):
    """BASELINE config #4: the pairs through the assign CLI's own batch
    loop (cli.assign.batch_loop, the path of `assign DB r1 r2`), a
    warm-up of one batch and --repeat timed passes; with --mesh the same
    passes over make_mesh(), rows held bit for bit against the passes
    without it.  Fills `res`; returns the gate names for parity."""
    import io
    import logging
    import torch
    from hmmufotu_tpu_torch.cli.assign import batch_loop, build_parser
    from hmmufotu_tpu_torch.hmm import GLOBAL
    from hmmufotu_tpu_torch.hmm.viterbi import TIMING
    cuda = dev.type == "cuda"
    cli = build_parser().parse_args(
        ["db", "r1.fa", "r2.fa", "-b", str(args.batch), "-N",
         str(args.max_nseed)])
    # one warning a badly oriented pair: counted from the rows instead
    logging.getLogger("hmmufotu_tpu_torch.cli.assign").setLevel(
        logging.ERROR)
    n = len(fwd)
    W = placer.W

    def one_pass(f, r, mesh=None):
        # the placement's results reach the host inside the loop, so only
        # the aligner's card may still be busy at its end
        out, chi = io.StringIO(), io.StringIO()
        clock.reset()
        t0 = time.perf_counter()
        batch_loop(cli, aligner, csfm, tree, placer, f, r, GLOBAL, None,
                   out, chi, None, mesh)
        clock.end_pass()
        if cuda:
            torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0, out.getvalue().splitlines(),
                chi.getvalue().splitlines())

    def timed(label, mesh=None):
        runs, stages, busy, enq = [], [], [], []
        TIMING.clear()
        for k in range(args.repeat):
            log(f"{label} pass {k + 1} of {args.repeat}...")
            shards.reset()
            dt, rows, chi = one_pass(fwd, rev, mesh)
            runs.append(n / dt)
            stages.append(dict(clock.s))
            if cuda:
                busy.append(shards.busy_ms())
            enq.append(dict(shards.enqueue_s))
            log(f"  {n / dt:.1f} pairs/s")
        per = lambda d: {k: float(np.mean([x[k] for x in d])) for k in d[0]}
        out = {"pairs_per_s_runs": runs,
               "pairs_per_s": float(np.median(runs)),
               "pairs_per_s_spread": [min(runs), max(runs)],
               "mates_per_s": 2 * float(np.median(runs)),
               "stages_s": per(stages),
               "align_substages_s": {k: v / args.repeat
                                     for k, v in TIMING.items()},
               "placement_enqueue_s": per(enq),
               "card_busy_ms": per(busy) if busy else None}
        if busy:
            out["busy_over_placement"] = (
                sum(out["card_busy_ms"].values()) / 1e3
                / out["stages_s"]["placement"])
        return out, rows, chi, placement_rows(clock.calls)

    os.environ["HMMUFOTU_TIMING"] = "1"
    with LoopClock(pl) as clock, ShardClock(cuda) as shards:
        t0 = time.perf_counter()
        log("warm-up...")
        one_pass(fwd[:args.batch], rev[:args.batch])
        res["t_compile_s"] = time.perf_counter() - t0
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        got, rows, chi, (alns, best) = timed("timed")
        res.update(got)
        res["device_peak_gb"] = device_peak_gb(dev)
        res["db_resident_gb"] = db_resident_gb(placer)
        if args.profile:
            k2 = 2 * args.batch
            res["profile"] = profile_window(
                lambda: one_pass(fwd[:k2], rev[:k2]), args.profile,
                dev)
        if args.mesh:
            from hmmufotu_tpu_torch.parallel import make_mesh
            mesh = make_mesh(device=dev.type)
            t0 = time.perf_counter()
            log(f"replicas of the tree on {mesh.size} shards...")
            for d in mesh.devices:
                placer.on_device(d)
                if cuda:
                    torch.cuda.synchronize(d)
            res["mesh_shards"] = mesh.size
            res["mesh_devices"] = sorted({str(d) for d in mesh.devices})
            res["t_replicas_s"] = time.perf_counter() - t0
            one_pass(fwd[:args.batch], rev[:args.batch], mesh)
            if cuda:
                for d in set(mesh.devices):
                    torch.cuda.reset_peak_memory_stats(d)
            m_got, m_rows, m_chi, (m_alns, m_best) = timed("mesh", mesh)
            res.update({"mesh_" + k: v for k, v in m_got.items()})
            if cuda:
                res["mesh_device_peak_gb"] = {
                    str(d): device_peak_gb(d) for d in set(mesh.devices)}
            res["mesh_rows_equal"] = (m_rows == rows and m_chi == chi
                                      and exact_rows(m_best)
                                      == exact_rows(best))
    os.environ.pop("HMMUFOTU_TIMING", None)

    spans = np.array([aln_span(a) if a.is_valid() else 0 for a in alns])
    ok = spans[spans > 0]
    res["pairs"] = n
    res["pairs_merged"] = len(rows)
    res["pairs_badly_oriented"] = len(chi)
    res["pairs_placed"] = int(sum(b is not None for b in best))
    res["merged_span_percentiles"] = dict(zip(
        ("min", "p5", "p25", "p50", "p75", "p95", "max"),
        (np.percentile(ok, [0, 5, 25, 50, 75, 95, 100]).tolist()
         if len(ok) else [None] * 7)))
    res["merged_wider_than_W"] = int((ok > W).sum())
    res["merged_wider_than_W_share"] = float((ok > W).mean()) \
        if len(ok) else None

    if not min(args.parity, n):
        return []
    # the first --parity pairs against the exact host SEP path: on the
    # merged alignment clipped to the device's window (the reference
    # package's semantics, gated), and on the whole merged alignment
    # (the clamp's cost, reported)
    log("parity...")
    t0 = time.perf_counter()
    P = range(min(args.parity, n))
    clipped = [clip_to_device_window(a, W) for a in alns]
    host_clip = host_placements(pl, tree, clipped, best, P, args)
    wide = [r for r in P if spans[r] > W]
    narrow = [r for r in host_clip if spans[r] <= W]
    host_wide = host_placements(pl, tree, alns, best, wide, args)
    for tag, host in (("parity_clip_", host_clip),
                      ("parity_full_narrow_",
                       {r: host_clip[r] for r in narrow}),
                      ("parity_full_wide_", host_wide)):
        got = agreement(best, host, spans, W, tag[:-1])
        res.update({tag + k: v for k, v in got.items()})
    res["t_parity_s"] = time.perf_counter() - t0
    return ["parity_clip_"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--leaves", type=int, default=75000)
    ap.add_argument("--length", type=int, default=6000)
    ap.add_argument("--reads", type=int, default=20480)
    ap.add_argument("--read-len", type=int, default=250)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--window", type=int, default=512)
    ap.add_argument("--span", type=int, default=1024,
                    help="resident site-window width Ws")
    ap.add_argument("--msg-dtype", default="f32",
                    choices=["bf16", "f32"])
    ap.add_argument("--model", default="GTR")
    ap.add_argument("--parity", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-nseed", type=int, default=50)
    ap.add_argument("--cache", default=os.path.join(
        REPO, ".bench", "torch_scale_cache"),
        help="dir caching msgs/CSFM/HMM between runs ('' for none)")
    ap.add_argument("--eval-only", action="store_true",
                    help="evaluate + write the msg cache, exit")
    ap.add_argument("--repeat", type=int, default=3,
                    help="timed streams of the read set after the warm-up")
    ap.add_argument("--profile", default="",
                    help="dir: torch.profiler trace of a stream of two "
                         "batches after the timed streams, with the top "
                         "ops' device time and the device's idle share")
    ap.add_argument("--device", default="cuda",
                    help="cuda; cpu only when asked for")
    ap.add_argument("--whole-tree", action="store_true",
                    help="evaluate every column and keep the whole tree's "
                         "messages on the device (the assign CLI's "
                         "default placer); --span then only bounds the "
                         "columns the reads come from")
    ap.add_argument("--paired", action="store_true",
                    help="BASELINE config #4: --reads pairs of 2 x "
                         "--read-len mates through the assign CLI's batch "
                         "loop, the whole tree on the device (implies "
                         "--whole-tree)")
    ap.add_argument("--mesh", action="store_true",
                    help="with --paired: the passes again over "
                         "make_mesh() (every local card; eight CPU shards "
                         "with --device cpu), rows held bit for bit "
                         "against those without it")
    args = ap.parse_args(argv)
    if args.mesh and not args.paired:
        ap.error("--mesh runs with --paired")
    if args.paired:
        args.whole_tree = True

    import torch
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch._cuda import resolve_device
    from hmmufotu_tpu_torch.hmm import GLOBAL, ViterbiAligner
    from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"

    rng = np.random.default_rng(args.seed)
    res = {"device": str(dev), "card": card_line(dev),
           "mode": "end_to_end", "leaves": args.leaves,
           "length": args.length, "msg_dtype": args.msg_dtype,
           "batch": args.batch, "read_len": args.read_len,
           "whole_tree": args.whole_tree, "paired": args.paired}

    # ---- tree + model (the construction of torch_scale_assign) ----------
    t0 = time.perf_counter()
    log("synth tree...")
    tree = synth_tree(args.leaves, args.length, args.seed)
    load_tree_model(tree, args.model)
    res["n_nodes"] = tree.num_nodes
    leaves = np.nonzero(tree.has_seq)[0]
    res["t_synth_s"] = time.perf_counter() - t0

    # ---- MSA -> CSFM + HMM (cached) -------------------------------------
    csfm, hmm = build_index_and_hmm(tree, leaves, args, res)

    # ---- window-restricted evaluate (cache shared with the placement
    # harness) -------------------------------------------------------------
    s_lo, Ws = site_window(args.length, args.span)
    log("evaluate the " + ("whole tree..." if args.whole_tree
                           else "message window..."))
    window_messages(tree, args, s_lo, Ws, dev, res, whole=args.whole_tree)
    if args.eval_only:
        print(json.dumps({"eval_only": True, **res}))
        return 0

    # ---- raw read strings from in-window leaf fragments -----------------
    # before infer_seq: reads come from leaf sequences only
    t0 = time.perf_counter()
    log("simulate reads...")
    if args.paired:
        # the fragment sizes of the reference's read simulator
        from hmmufotu_tpu_torch.cli.sim import (DEFAULT_MEAN_SIZE,
                                                DEFAULT_SD_SIZE)
        fwd, rev, _, _ = simulate_pairs(
            tree, args.reads, s_lo, s_lo + Ws, args.read_len, rng,
            DEFAULT_MEAN_SIZE, DEFAULT_SD_SIZE)
        res["fragment_columns"] = [DEFAULT_MEAN_SIZE, DEFAULT_SD_SIZE]
    else:
        wins_full, _, _, leaf_ids = simulate_window_reads(
            tree, args.reads, s_lo, s_lo + Ws, args.read_len, rng)
        reads = ["".join("ACGT"[c] for c in row[row >= 0])
                 for row in wins_full]
    res["t_simreads_s"] = time.perf_counter() - t0

    # ancestral sequences (the reference's build runs inferSeq, so the
    # seed search sweeps every non-root node); exact inside the window
    t0 = time.perf_counter()
    log("infer_seq...")
    tree.infer_seq()
    res["t_inferseq_s"] = time.perf_counter() - t0

    # ---- the pipeline's objects ------------------------------------------
    log("aligner + placer staging...")
    hmm.set_sequence_mode(GLOBAL)
    hmm.wing_retract()
    aligner = ViterbiAligner(hmm, device=dev)
    msg_dtype = torch.bfloat16 if args.msg_dtype == "bf16" else None
    t0 = time.perf_counter()
    placer = DevicePlacer(tree, window=args.window,
                          max_nseed=args.max_nseed, device=dev,
                          msg_dtype=msg_dtype,
                          site_window=None if args.whole_tree
                          else (int(s_lo), int(Ws)))
    if cuda:
        torch.cuda.synchronize(dev)
    res["t_stage_s"] = time.perf_counter() - t0

    if args.paired:
        gates = paired_run(args, res, pl, tree, csfm, aligner, placer, dev,
                           fwd, rev)
        res["peak_rss_gb"] = peak_rss_gb()
        print(json.dumps(res))
        ok = res.get("mesh_rows_equal", True) and all(
            min(res[g + "cnode_match"], res[g + "loglik_match"])
            >= 0.95 * res[g + "reads"] for g in gates)
        return 0 if ok else 1

    # count the reads the exact host path places (out-of-window
    # alignments), and clock it and the seed search (host seconds; the
    # seed search runs in assign_stream's worker thread, beside the
    # main thread's stages)
    n_host = [0]
    clock = {"seed_search": 0.0, "host_fallback": 0.0}
    orig_assign_read = pl.assign_read
    orig_seed = pl.batch_find_seed_vpaths

    def clocked(key, fn):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                clock[key] += time.perf_counter() - t
        return wrapper

    def counting_assign_read(*a, **kw):
        n_host[0] += 1
        return clocked("host_fallback", orig_assign_read)(*a, **kw)

    pl.assign_read = counting_assign_read
    pl.batch_find_seed_vpaths = clocked("seed_search", orig_seed)
    os.environ["HMMUFOTU_TIMING"] = "1"
    from hmmufotu_tpu_torch.hmm.viterbi import TIMING

    def stream(read_list, srng):
        all_alns, all_best = [], []
        for alns, best in pl.assign_stream(
                aligner, csfm, tree, placer, read_list, args.batch,
                mode=GLOBAL, rng=srng):
            all_alns.extend(alns)
            all_best.extend(best)
        if cuda:
            torch.cuda.synchronize(dev)
        return all_alns, all_best

    # ---- warm-up --------------------------------------------------------
    t0 = time.perf_counter()
    log("warm-up...")
    stream(reads[:args.batch], np.random.default_rng(1))
    res["t_compile_s"] = time.perf_counter() - t0

    # ---- timed streams of the same read set -----------------------------
    TIMING.clear()
    for k in clock:
        clock[k] = 0.0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    runs, hosts = [], []
    for k in range(args.repeat):
        n_host[0] = 0
        log(f"timed stream {k + 1} of {args.repeat}...")
        t0 = time.perf_counter()
        alns, best = stream(reads, np.random.default_rng(2))
        dt = time.perf_counter() - t0
        runs.append(args.reads / dt)
        hosts.append(n_host[0])
        log(f"  {args.reads / dt:.1f} reads/s")
    os.environ.pop("HMMUFOTU_TIMING", None)
    if args.profile:
        res["profile"] = profile_window(
            lambda: stream(reads[:2 * args.batch], np.random.default_rng(2)),
            args.profile, dev)
    pl.assign_read = orig_assign_read
    pl.batch_find_seed_vpaths = orig_seed
    res["reads_total"] = args.reads
    res["reads_aligned"] = int(sum(a.is_valid() for a in alns))
    res["reads_placed"] = int(sum(b is not None for b in best))
    res["host_fallback_reads"] = hosts[0]
    res["host_fallback_reads_runs"] = hosts
    res["repeat"] = args.repeat
    res["reads_per_s_runs"] = runs
    res["reads_per_s"] = float(np.median(runs)) if runs else None
    res["reads_per_s_spread"] = [min(runs), max(runs)] if runs else None
    # the stage clocks summed over the timed streams, per stream
    res["align_substages_s"] = {k: v / max(args.repeat, 1)
                                for k, v in TIMING.items()}
    res["host_stages_s"] = {k: v / max(args.repeat, 1)
                            for k, v in clock.items()}
    res["device_peak_gb"] = device_peak_gb(dev)
    res["db_resident_gb"] = db_resident_gb(placer)

    # ---- parity: the first P alignments vs the exact host SEP path ------
    if min(args.parity, args.reads):
        log("parity...")
        res.update(parity(pl, aligner, csfm, tree, placer, reads, leaf_ids,
                          args, GLOBAL))

    gates = ["parity_"] if "parity_reads" in res else []
    if args.whole_tree:
        # the reads the window-resident placer would send to the exact
        # host path, placed here on the device, against that path
        oow = out_of_window(alns, s_lo, Ws, placer.W)
        log(f"parity of the {len(oow)} reads outside the span...")
        t0 = time.perf_counter()
        got = host_agreement(pl, tree, alns, best, oow, placer.W, args,
                             "out-of-span parity")
        res["t_parity_oow_s"] = time.perf_counter() - t0
        res.update({"parity_oow_" + k: v for k, v in got.items()})
        gates.append("parity_oow_")
    res["peak_rss_gb"] = peak_rss_gb()
    print(json.dumps(res))
    ok = all(min(res[g + "cnode_match"], res[g + "loglik_match"])
             >= 0.95 * res[g + "reads"] for g in gates)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
