#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hmmufotu_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA H100.  Phases:

  1. card     nvidia-smi name and power limit, torch and CUDA versions;
  2. build    nvcc builds every kernel of hmmufotu_tpu_torch/csrc;
  3. fixture  the 70_otus DB (GTR+dGamma4) built with the port's builder;
  4. kernels  K1 (banded Viterbi, narrow and wide launches timed one by
              one, 3 and 5 region slots), K2 (estimate, with its bound for
              the masked sites and the per-lane layout's), K3 (SEP
              optimize, 1 and 4 Gamma rates), K4 (choice-plane Viterbi,
              and the host walk over its planes against K1's tracebacks)
              and K5 (single-branch fixed point, with its chain floor) on
              inputs captured from the two paths at the benchmark's
              shapes, each held against its plain PyTorch version on the
              same CUDA tensors;
  5. assign   1,024 simulated reads through pipeline.assign_stream on the
              card, every kernel launch counter checked, alignments and
              best placements compared with a CPU run of the port;
  6. modes    the second path: 2,048 reads through assign_stream with the
              host-traceback aligner (K4) and the fixed-point placer
              (K5), launch counters checked, compared read for read with
              the main path; 64 reads each through the scan aligner and
              through K3 fed by the tensor-op estimate;
  7. pe       the assign CLI on 512 read pairs written by the port's sim
              (GLOBAL alignment of both mates, merge, device placement)
              and on 64 pairs of 600 bp inserts, on the card and on the
              CPU: K1-K3 launches, pairs/s, merged and badly oriented
              pairs, merged reads wider than the placer's window, rows
              compared;
  8. chimera  assign -C on a synthetic chimera and 64 simulated reads, on
              the card (which only aligns) and on the CPU: the same rows
              and chimera rows byte for byte, the chimera flagged and no
              clean read;
  9. evaluate the torch evaluate engine on the card against the numpy f64
              engine on the fixture tree, twice (bit-equal), its peak
              device memory within its budget;
 10. scale    a synthetic DB of 16,384 leaves x 6,000 columns, the gg_97
              shape's width (GTR+dGamma4, leaf sequences evolved down the
              tree, likelihood sweeps by the torch engine on the card),
              8,192 simulated 250 bp reads in batches of 2,048: reads/s,
              per-kernel launches and CUDA-event time (K1 by launch width;
              K3 by launch with its live lanes, trip counts and bound),
              peak device memory, K1's full-width launch (8 lanes a thread)
              and a 2,048-lane band (4 a thread) each bit-equal to the
              plain version, the host-clock stages of one batch, and 64
              reads compared with a CPU run; the torch evaluate engine on
              the synthetic tree against the numpy f64 engine on 256 of
              its columns; resident: the window-resident placer (1,024
              columns, f32 and bf16 messages) on the reads inside its
              window against the full-width placer and a CPU run;
 11. parallel the assign CLI with --mesh and --mesh-tree on the 1,024
              fixture reads over the one-card mesh, against the CLI without
              them; four shards on the one card (a mesh that names cuda:0
              four times) at the scale shape, one batch of 2,048 reads:
              sharded_place_batch against the single-device placement,
              sharded_place_batch_tree with the host merge against it too,
              with wall time, reads/s, peak memory and each shard's message
              bytes; assign --num-processes 2 as two processes over gloo
              (on the one card; with two cards or more one card a process
              by CUDA_VISIBLE_DEVICES) on the fixture reads, starting from
              a build directory without the libraries (both processes
              build at once), then on the [pe] phase's 512 fixture pairs
              (the batch loop), rows byte-equal to the one-process run's;
 12. cli      the build CLI writes an evolved DB of 2,048 leaves x 6,000
              columns to files (torch evaluate engine), and the assign CLI
              loads it on the card with its default placer (the whole
              tree on the card) and with --resident-window 1024, each on
              2,048 amplicon reads: stage seconds, file sizes, launches,
              and the first 64 rows of each against a CPU run of the
              assign CLI;
 13. gamma    BASELINE config #3's path at the cli phase's shape: the
              build CLI with -V (dGamma4: the alpha estimate and a second
              torch evaluate) on the cli phase's inputs, the assign CLI on
              the card on its 2,048 amplicon reads, launches counted from
              0, the loaded messages f32 and 4 rates on the placer, the
              first 64 rows against a CPU run of the assign CLI;
 14. pe       paired-end assign on the cli phase's DB files (no second
              build): 1,024 pairs of 2 x 250 bp mates written by the
              port's sim CLI at its defaults (fragments of 500 +- 30
              columns) through the assign CLI on the card, launches
              counted from 0, pairs/s, merged pairs wider than W, device
              peak; the first 64 pairs through the CLI on the CPU, row for
              row (alignments equal, the synthetic DBs' near-tie rule) and
              the same badly oriented pairs;
 15. otu      BASELINE config #5's path on the cli phase's DB files: a
              second sample of 2,048 amplicon reads of the same region from
              another community (scripts/torch_scale_sum.py's sampler)
              through the assign CLI on the card, launches counted from 0;
              the sum CLI once a host (the cli phase's TSV is host A, the
              new one host B; -l -c -t) and merge -db -t; the merged table
              against an independent count of the TSVs' rows by taxon, one
              consensus record of 6,000 columns an OTU, the OTU tree naming
              every OTU;
 16. oracle   BASELINE configs #1-#2's correctness target: the independent
              f64 oracle's goldens (tests/golden_*.tsv) through the port's
              build, sim, assign (on the card) and jplace CLIs, by
              tests/test_pipeline.py TestGoldenCategories' checks (40 of 40
              taxa with branches in the tie sets; 20 of 20 jplace edges,
              likelihoods and lengths); 64 JC69 reads and 16 GTR+dGamma4
              pairs through the port on the card against the oracle
              (tests/oracle/, one process a core), by
              scripts/torch_run_parity.py's rules; launches counted;
 17. flags    the assign CLI on the card and on the CPU with each of nine
              flag sets (tests/test_torch_cli_flags.py's eight and -C
              --ref-rank) on its 24 fixture reads, then on 64 reads of each
              substitution model's DB (JC69, K80, F81, HKY85, TN93, GTR,
              GTR -V): rows by that test's rules (-C byte-equal), K1-K3
              launches of each card run.

Prints one `kernels` JSON line before the last and, as the last line,
{"ok": true, "device": {...}}.  Exits non-zero, printing no result,
without a CUDA card, outside the repository, or when any phase fails.
Databases are written under .smoke/ (gitignored).  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke")
FIXTURES = os.path.join(REPO, "tests", "fixtures")

BATCH = 2048            # reads per device batch (bench.py's batch)
READ_LEN = 250
N_FIXTURE_READS = 1024
N_SCALE_READS = 8192
SCALE_LEAVES = 16384
SCALE_COLS = 6000       # the gg_97 shape's columns, not cut
N_SCALE_CPU_READS = 64
RESIDENT_COLS = 1024    # the window-resident placer's site window
EVAL_WINDOW = 256       # columns of the numpy engine's check at scale
N_MODE_READS = 64       # reads of the short scan / tensor-op-estimate runs
N_PAIRS = 512           # read pairs of the paired-end phase
N_WIDE_PAIRS = 64       # pairs with 600 bp inserts (wider than W = 512)
N_CHIMERA_CLEAN = 64    # simulated reads beside the chimera
CLI_LEAVES = 2048       # the [cli] phase's evolved DB: 4,095 nodes
N_CLI_READS = 2048      # its amplicon reads, one assign batch
N_CLI_CPU_READS = 64    # the first of them in the CPU run
N_CLI_PAIRS = 1024      # sim CLI pairs at its defaults on the [cli] DB
N_CLI_CPU_PAIRS = 64    # the first of them in the CPU run
N_OTU_READS = 2048      # the [otu] phase's second sample
OTU_LEAVES = 1000       # its community's leaves
OTU_SEED = 9            # its sampler's seed
N_ORACLE_SE = 64        # [oracle]: JC69 single-end reads (seed 11)
N_ORACLE_PE = 16        # GTR+dGamma4 pairs (seed 13)
N_ORACLE_HOST = 16      # of the single-end reads also placed on the host
N_FLAG_READS = 24       # [flags]: tests/test_torch_cli_flags.py's reads
N_MODEL_READS = 64      # reads a substitution model
FLAG_SETS = [["--opt-k", "4"], ["--ref-rank"], ["--ML"],
             ["--resident-window", "700"], ["--msg-bf16"], ["--align-only"],
             ["-d", "0.05", "-H", "0.5"], ["--prior", "height"],
             ["-C", "--ref-rank"]]
MODEL_SETS = [("JC69", ()), ("K80", ()), ("F81", ()), ("HKY85", ()),
              ("TN93", ()), ("GTR", ()), ("GTR", ("-V",))]
# the reference package's tolerances between its two evaluate engines
# (tests/test_scale_eval.py): messages on finite entries, tree loglik
EVAL_ATOL, EVAL_LL_RTOL = 0.05, 1e-5

# device peaks for the bound (H100 SXM data sheet, dense, 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# operations counted from the recurrences (adds, multiplies, mins,
# compares; one per exp/log): one DP cell of K1; one site of one P(t)
# convolution, of one pi-dot and of one fixed-point step
K1_OPS_PER_CELL = 40
CONV_OPS = 40
DOT_OPS = 14
FP_STEP_OPS = 6
K2_OPS_PER_SITE = 3 * CONV_OPS + DOT_OPS + 16

# device clock cycles of spin per timed call (cuda_ms): ~0.5 ms at the
# H100's clocks, more than a wrapper takes to enqueue its work
SPIN_CYCLES_PER_CALL = 1_000_000

# relative/absolute tolerances of tests/test_pipeline.py:210-216
BRANCH_ATOL = 2e-3
LL_RTOL, LL_ATOL = 1e-4, 0.5
# Q values of the tree-sharded merge against the single-device
# placement (tests/test_sharding.py:119-125), or their error
# probabilities within Q_ULPS f32 ulps of 1 (q_close)
Q_ATOL, Q_ULPS = 0.05, 4
# K5's p against a plain version: summed in another order, a lane may
# stop one step apart inside BRANCH_EPS = 1e-5 of its limit
FP_ATOL, FP_RTOL = 1e-6, 1e-5
# a placement loglik from bf16-stored messages against one from f32: each
# stored message is rounded to within 2^-8 of itself (8 significant bits),
# so a site's loglik, a log-sum-exp led by the sum of two messages that
# are both <= 0, moves by about 2^-8 of its magnitude, and the optimum
# over the branch lengths no further
BF16_LL_RTOL = 2.0 ** -8


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# databases
# ---------------------------------------------------------------------------

def build_fixture_db(prefix: str) -> float:
    from hmmufotu_tpu_torch.cli.build import main as build_main
    t = time.time()
    rc = build_main([os.path.join(FIXTURES, "70_otus.fasta"),
                     os.path.join(FIXTURES, "70_otus.tree"),
                     "-a", os.path.join(FIXTURES, "70_otus_taxonomy.txt"),
                     "-n", prefix, "-s", "GTR", "-V"])
    if rc != 0:
        raise RuntimeError("fixture DB build failed")
    return time.time() - t


def build_synth_db(d: str, n_leaves: int, n_cols: int):
    """The synthetic DB, built in memory by the port's builder, its
    likelihood sweeps by the torch engine on the card."""
    from evolved_inputs import synth_inputs
    from hmmufotu_tpu_torch.cli.build import build_database, build_parser
    from hmmufotu_tpu_torch.hmm import NGCL
    t = time.time()
    n_nodes, max_depth = synth_inputs(d, n_leaves, n_cols)
    t_gen = time.time() - t
    args = build_parser().parse_args([
        os.path.join(d, "synth.fasta"), os.path.join(d, "synth.tree"),
        "-a", os.path.join(d, "synth_taxonomy.txt"), "-s", "GTR", "-V",
        "--msg-dtype", "f32", "--eval-engine", "torch"])
    db = build_database(args, "synth", device="cuda")
    if db is None:
        raise RuntimeError("synthetic DB build failed")
    db.hmm.set_sequence_mode(NGCL)
    db.hmm.wing_retract()
    return db, n_nodes, max_depth, t_gen, time.time() - t - t_gen


def load_db(prefix: str):
    from hmmufotu_tpu_torch.db import Database
    from hmmufotu_tpu_torch.hmm import NGCL
    db = Database.load(prefix)
    db.hmm.set_sequence_mode(NGCL)
    db.hmm.wing_retract()
    return db


# ---------------------------------------------------------------------------
# driving the main path
# ---------------------------------------------------------------------------

def run_assign(db, reads, device, batch, aligner_kw=None, placer_kw=None):
    """pipeline.assign_stream over `reads`; returns (alignments, best).
    aligner_kw/placer_kw choose the aligner's and the placer's mode."""
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch.hmm import NGCL, ViterbiAligner
    from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
    aligner = ViterbiAligner(db.hmm, device=device, **(aligner_kw or {}))
    placer = DevicePlacer(db.ptu, window=512, device=device,
                          **(placer_kw or {}))
    alns, best = [], []
    for a, b in pl.assign_stream(aligner, db.csfm, db.ptu, placer, reads,
                                 batch, mode=NGCL):
        alns.extend(a)
        best.extend(b)
    return alns, best


def compare_runs(gpu, cpu, max_node_frac, cost_rtol=0.0, ll_rtol=LL_RTOL):
    """Alignments must be identical (K1 and K4 are bit-exact; against the
    scan aligner, whose D chain sums in another order, costs may differ
    by cost_rtol); best placements
    must pick the same (c, p, a) nodes, a differing read being accepted
    only as a near tie: the two runs' best logliks agree within the
    placement tolerance, and at most max_node_frac of the reads differ.
    The synthetic DB's sibling leaves are nearly identical, so its
    candidates tie to f32 rounding, which the two runs sum in different
    orders.  ll_rtol replaces LL_RTOL where one side stores its messages
    in bf16."""
    (ga, gb), (ca, cb) = gpu, cpu
    n_aln = sum(a.align != b.align
                or abs(a.cost - b.cost) > cost_rtol * abs(b.cost)
                for a, b in zip(ga, ca))
    n_valid = n_diff = n_bad = 0
    max_ll = max_ratio = 0.0
    for p, q in zip(gb, cb):
        if (p is None) != (q is None):
            n_bad += 1
            continue
        if p is None:
            continue
        n_valid += 1
        for x in (p.loglik, p.ratio, p.wnr, p.q_place, p.q_taxon):
            if not math.isfinite(x):
                n_bad += 1
        tol = LL_ATOL + ll_rtol * abs(q.loglik)
        if abs(p.loglik - q.loglik) > tol:
            n_bad += 1
        if (p.c_node, p.p_node, p.a_node) != (q.c_node, q.p_node, q.a_node):
            n_diff += 1
            continue
        max_ll = max(max_ll, abs(p.loglik - q.loglik))
        max_ratio = max(max_ratio, abs(p.ratio - q.ratio))
    ok = (n_aln == 0 and n_bad == 0 and n_valid > 0
          and n_diff <= max_node_frac * n_valid)
    return ok, dict(reads=len(gb), aln_mismatch=n_aln, placed=n_valid,
                    node_mismatch_near_tie=n_diff, bad=n_bad,
                    max_loglik_diff=max_ll, max_ratio_diff=max_ratio)


def batch_stages(db, reads, dp_name, finish_name, aligner_kw=None,
                 placer_kw=None):
    """Seconds of each stage of one batch through a path, run one after
    the other with the device drained in between: seed search, the DP
    dispatch (encode, upload, kernel), the aligner's finish (download,
    any host walk, alignment strings), placement."""
    import torch
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch.hmm import NGCL, ViterbiAligner
    from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
    aligner = ViterbiAligner(db.hmm, device="cuda", **(aligner_kw or {}))
    placer = DevicePlacer(db.ptu, window=512, device="cuda",
                          **(placer_kw or {}))
    out = {}

    def stage(name, fn):
        t = time.time()
        res = fn()
        torch.cuda.synchronize()
        out[name] = round(time.time() - t, 3)
        return res

    vp = stage("seed_s", lambda: pl.batch_find_seed_vpaths(
        db.hmm, db.csfm, reads, mode=NGCL))
    h = stage(dp_name, lambda: aligner.dispatch_batch(reads, vp))
    alns = stage(finish_name, lambda: aligner.finalize_batch(h))
    stage("place_s", lambda: pl.assign_batch_device(db.ptu, placer, alns))
    return out


class Patch:
    """Swap module attributes for the duration of a with-block."""

    def __init__(self, *triples):
        self.triples = triples
        self.saved = []

    def __enter__(self):
        for mod, name, new in self.triples:
            self.saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, new)
        return self

    def __exit__(self, *exc):
        for mod, name, old in reversed(self.saved):
            setattr(mod, name, old)


def kernel_table():
    """name -> (module, launcher attribute, source, TPU kernel replaced)
    of every kernel of the port."""
    from hmmufotu_tpu_torch.hmm import cuda_viterbi as cv
    from hmmufotu_tpu_torch.phylo import cuda_fixed_point as cf
    from hmmufotu_tpu_torch.phylo import cuda_place as cp
    vit = "hmmufotu_tpu_torch/csrc/viterbi.cu"
    place = "hmmufotu_tpu_torch/csrc/place.cu"
    return {
        "viterbi_traced": (cv, "viterbi_traced_cuda", vit,
                           "hmmufotu_tpu/hmm/pallas_viterbi.py:60"),
        "est": (cp, "est_cuda", place,
                "hmmufotu_tpu/phylo/pallas_place.py:378"),
        "sep_optimize": (cp, "sep_cuda", place,
                         "hmmufotu_tpu/phylo/pallas_place.py:109"),
        "viterbi_planes": (cv, "viterbi_planes_cuda", vit,
                           "hmmufotu_tpu/hmm/pallas_viterbi.py:60"),
        "fixed_point": (cf, "fixed_point_cuda", place,
                        "hmmufotu_tpu/phylo/placement.py:184"),
    }


MAIN_KERNELS = ("viterbi_traced", "est", "sep_optimize")
MODE_KERNELS = ("viterbi_planes", "fixed_point")


def capture_calls():
    """Record the arguments of every kernel-wrapper call the paths make
    (the calls still run)."""
    from hmmufotu_tpu_torch.hmm import cuda_viterbi as cv
    from hmmufotu_tpu_torch.phylo import cuda_fixed_point as cf
    from hmmufotu_tpu_torch.phylo import cuda_place as cp
    calls = {"viterbi": [], "est": [], "sep": [], "fp": []}

    def rec(key, fn):
        def wrapper(*args):
            calls[key].append(args)
            return fn(*args)
        return wrapper

    def rec_fp(fn):
        # a K5 call's inputs are 0.4 GB at full width and the placer makes
        # two an outer trip: keep the one with the most lanes iterating
        def wrapper(*args):
            n_iter = int((~args[4]).sum())
            if not calls["fp"] or n_iter > calls["fp"][0][0]:
                calls["fp"] = [(n_iter, args)]
            return fn(*args)
        return wrapper

    patch = Patch((cv, "viterbi_traced", rec("viterbi", cv.viterbi_traced)),
                  (cp, "est", rec("est", cp.est)),
                  (cp, "sep_optimize", rec("sep", cp.sep_optimize)),
                  (cf, "fixed_point", rec_fp(cf.fixed_point)))
    return calls, patch


def sep_sites(maskp):
    """Masked sites of each K3 lane, [M] on the device."""
    return (maskp > 0.5).sum(1)


def launch_notes():
    """What event_timers keeps of a launch beside its events: K1's batch
    and lane width; K3's mask, live lanes, rates and trip counts.  Only
    references are kept, so a note puts no work on the stream of the run
    it watches; scale_launch_report reads them after the run."""
    return {
        "viterbi_traced": lambda a, out: (a[3].shape[0], a[8]),
        "sep_optimize": lambda a, out: (a[3], a[7], a[9], out[4], out[5]),
    }


def event_timers():
    """Wrap every CUDA launcher so that each launch is bracketed by CUDA
    events on the launching stream.  Returns (events, notes, patch):
    events[name] the (start, end) pairs, notes[name] the launch_notes
    entry of each launch, taken after the end event."""
    import torch
    events = {name: [] for name in kernel_table()}
    notes = {name: [] for name in kernel_table()}
    note_fns = launch_notes()

    def timed(key, fn):
        def wrapper(*args):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*args)
            e.record()
            events[key].append((s, e))
            if key in note_fns:
                notes[key].append(note_fns[key](args, out))
            return out
        # the launcher counts through its module-level name, which now
        # resolves to this wrapper
        wrapper.launches = fn.launches
        return wrapper

    patch = Patch(*((mod, attr, timed(name, getattr(mod, attr)))
                    for name, (mod, attr, _, _) in kernel_table().items()))
    return events, notes, patch


def counters():
    return {name: getattr(mod, attr).launches
            for name, (mod, attr, _, _) in kernel_table().items()}


def reset_counters():
    cnt = counters()
    for c in cnt.values():
        c.reset()
    return cnt


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Device time of one call of fn, by CUDA events around reps calls.
    A spin kernel ahead of the first event keeps the device busy while
    the host enqueues the calls, so the events see them back to back and
    not the host's enqueue time."""
    import torch
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES_PER_CALL * reps)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def cuda_once(fn):
    """(result, ms) of one call, by CUDA events: the plain versions are
    run once, for the comparison, and that run is their time."""
    import torch
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def dp_cells(meta, n_rows, K, n_regions) -> int:
    """DP cells the banded regions of one batch allow (rows up to each
    read's length): the work the data needs."""
    from hmmufotu_tpu_torch.hmm.viterbi import MAX_REGIONS, REGION_WIDTH
    meta = meta.cpu().numpy().astype(np.int64)
    B = meta.shape[0]
    reg = meta[:, 8:8 + MAX_REGIONS * REGION_WIDTH] \
        .reshape(B, MAX_REGIONS, REGION_WIDTH)[:, :n_regions, :, None]
    j_lo, j_hi, i_lo, i_hi, _, diag, lo_d, hi_d = \
        (reg[:, :, c] for c in range(REGION_WIDTH))
    i = np.arange(1, n_rows + 1)[None, None, :]
    ci = i - i_lo
    lo = np.where(diag != 0, np.maximum(np.maximum(j_lo, 1),
                                        j_lo + ci - hi_d), np.maximum(j_lo, 1))
    hi = np.where(diag != 0, np.minimum(np.minimum(j_hi, K),
                                        j_lo + ci - lo_d), np.minimum(j_hi, K))
    w = np.where((i >= i_lo) & (i <= i_hi), np.maximum(hi - lo + 1, 0), 0)
    live = i[0] <= meta[:, 0:1]                       # [B, n_rows]
    return int((w.sum(1) * live).sum())


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


def bound(n_bytes: float, n_ops: float):
    tb = n_bytes / PEAK_BYTES_S * 1e3
    to = n_ops / PEAK_F32_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check_k1(calls, label):
    """Kernel vs plain on every recorded K1 call: comb bit-equal."""
    import torch
    from hmmufotu_tpu_torch.hmm import cuda_viterbi as cv
    res = dict(ms=0.0, plain_ms=0.0, bytes=0, ops=0, max_abs_err=0.0,
               launch_ms=[])
    for call in calls:
        got = cv.viterbi_traced_cuda(*call)
        want, plain_ms = cuda_once(lambda: cv.viterbi_traced_plain(*call))
        if got.shape != want.shape or not torch.equal(got, want):
            bad = (got != want).any(1).nonzero().flatten()[:8].tolist()
            raise AssertionError(f"K1 {label}: comb differs from the plain "
                                 f"version in rows {bad}")
        ms = cuda_ms(lambda: cv.viterbi_traced_cuda(*call), 5)
        res["ms"] += ms
        res["launch_ms"].append({"reads": call[3].shape[0],
                                 "lanes": call[8], "ms": ms})
        res["plain_ms"] += plain_ms
        tc, em, scal, codes, meta, jb = call[:6]
        res["bytes"] += nbytes(tc, em, scal, codes, meta, jb, got)
        res["ops"] += K1_OPS_PER_CELL * dp_cells(meta, call[6], call[7],
                                                 call[10])
        log(f"  K1 {label}: B={codes.shape[0]} n_rows={call[6]} KP={call[8]}"
            f" n_regions={call[10]} dchain={call[11]}: comb bit-equal, "
            f"{ms:.3f} ms")
    return res


def k2_work(maskr, C):
    """(bytes, old per-lane bytes, operations, masked lane-sites) of a K2
    launch for this data.  Bytes: U and V at the masked lane-sites, N at
    the masked read-sites, the mask once per read, the scalars, the model
    and the outputs.  The old count is that of the per-lane layout the
    kernel took before (every lane's four planes and mask read in full)."""
    B, Wp = maskr.shape
    M = B * C
    read_sites = int((maskr > 0.5).sum())
    lane_sites = read_sites * C
    n_bytes = lane_sites * 2 * 4 * 4 + read_sites * 4 * 4 + B * Wp * 4 \
        + M * 2 * 4 + 64 * 4 + M * 2 * 4
    old_bytes = (3 * 4 + 1) * M * Wp * 4 + M * 2 * 4 + 64 * 4 + M * 2 * 4
    return n_bytes, old_bytes, lane_sites * K2_OPS_PER_SITE, lane_sites


def check_k2(call):
    import torch
    from hmmufotu_tpu_torch.phylo import cuda_place as cp
    t0 = time.time()
    est_k, wnr_k = cp.est_cuda(*call)
    (est_p, wnr_p), plain_ms = cuda_once(lambda: cp.est_plain(*call))
    maskr, C = call[3], call[7]
    cand_ok = torch.isfinite(est_p)
    if not torch.equal(torch.isfinite(est_k), cand_ok):
        raise AssertionError("K2: finite pattern differs")
    e_est = (est_k - est_p)[cand_ok].abs()
    e_wnr = (wnr_k - wnr_p).abs()
    if bool((e_est > LL_ATOL + LL_RTOL * est_p[cand_ok].abs()).any()) \
            or float(e_wnr.max()) > BRANCH_ATOL:
        raise AssertionError(f"K2 disagrees: est {float(e_est.max())}, "
                             f"wnr0 {float(e_wnr.max())}")
    n_bytes, old_bytes, ops, lane_sites = k2_work(maskr, C)
    M, Wp = maskr.shape[0] * C, maskr.shape[1]
    # masked sites where the leaf message is one observed base (one 0,
    # three -inf): pass 2 reads its convolution from the lane's table
    Nr = call[2]
    one_hot = ((Nr == 0).sum(0) == 1) & (torch.isinf(Nr).sum(0) == 3)
    masked = maskr > 0.5
    one_hot_share = float((one_hot & masked).sum()) / max(
        int(masked.sum()), 1)
    res = dict(ms=cuda_ms(lambda: cp.est_cuda(*call), 10),
               plain_ms=plain_ms, bytes=n_bytes, ops=ops,
               max_abs_err=max(float(e_est.max()), float(e_wnr.max())))
    b_new, b_old = bound(n_bytes, ops), bound(old_bytes, ops)
    res["old_bound_ms"] = b_old[0]
    log(f"  K2: B={maskr.shape[0]} C={C} M={M} Wp={Wp}: est max err "
        f"{float(e_est.max()):.3g}, wnr0 max err {float(e_wnr.max()):.3g}, "
        f"wnr0 bit-equal {torch.equal(wnr_k, wnr_p)}; masked share "
        f"{lane_sites / (M * Wp):.4f}, of it one-hot {one_hot_share:.4f}; "
        f"{res['ms']:.3f} ms against a bound "
        f"of {b_new[0]:.4f} ms ({b_new[1]}; the per-lane layout's count "
        f"{b_old[0]:.4f} ms, {b_old[1]}); check {time.time() - t0:.1f} s")
    return res


def k3_work(sites, lv, n_rates, outer, inner, Wp, M):
    """(bytes, operations) a K3 launch needs for this data: the live
    lanes' messages and mask read once and every lane's scalars and
    outputs; per live lane and masked site, two branch set-ups an outer
    trip, a fixed-point step an inner trip and the root loglik.  sites [M]
    masked sites, lv [M] live, outer/inner [M] trip counts."""
    import torch
    n_live = int(lv.sum())
    NR = n_rates
    mix = 4 * (3 * NR + 3) if NR > 1 else 0
    setup = NR * 2 * CONV_OPS + mix + 3 * DOT_OPS + 8
    final = NR * 3 * CONV_OPS + mix + DOT_OPS
    o, i = outer[lv].double(), inner[lv].double()
    ops = float((sites[lv].to(torch.float64)
                 * (o * 2 * setup + i * FP_STEP_OPS + final)).sum())
    n_bytes = n_live * (12 * Wp + Wp) * 4 + M * (3 * 4 + 1) + 64 * 4 \
        + 6 * 4 * M
    return n_bytes, ops


def check_k3(call, label):
    import torch
    from hmmufotu_tpu_torch.phylo import cuda_place as cp
    got = cp.sep_cuda(*call)
    want, plain_ms = cuda_once(lambda: cp.sep_plain(*call))
    Up, Vp, Np, maskp, w0, wur0, wnr0, live, ms, n_rates = call
    lv = live.reshape(-1)
    errs = [float((got[q] - want[q])[lv].abs().max()) if bool(lv.any())
            else 0.0 for q in range(4)]
    ll_p = want[3][lv]
    ll_bad = (got[3][lv] - ll_p).abs() > LL_ATOL + LL_RTOL * ll_p.abs()
    dead_zero = all(bool((got[q][~lv] == 0).all()) for q in range(6))
    if max(errs[:3]) > BRANCH_ATOL or bool(ll_bad.any()) or not dead_zero:
        raise AssertionError(f"K3 {label} disagrees: wur/wvr/wnr/loglik "
                             f"max err {errs}, dead lanes zero {dead_zero}")
    n_live = int(lv.sum())
    outer = got[4][lv].double()
    n_bytes, ops = k3_work(sep_sites(maskp), lv, n_rates, got[4], got[5],
                           maskp.shape[1], lv.numel())
    res = dict(ms=cuda_ms(lambda: cp.sep_cuda(*call), 3),
               plain_ms=plain_ms,
               bytes=n_bytes, ops=ops, max_abs_err=max(errs))
    same = [float((got[q][lv] == want[q][lv]).double().mean())
            if n_live else 1.0 for q in (4, 5)]
    log(f"  K3 {label}: M={lv.numel()} live={n_live} n_rates={n_rates}: "
        f"wur/wvr/wnr/loglik max err {[f'{e:.3g}' for e in errs]}, "
        f"mean outer trips {float(outer.mean()) if n_live else 0:.2f}, "
        f"lanes with the plain version's outer/inner trip counts "
        f"{same[0]:.4f}/{same[1]:.4f}")
    return res


def trace_strings(comb_h):
    """K1's comb -> per read (trace string, aln_start, aln_end, aln_from,
    aln_to), the form the host walk returns."""
    from hmmufotu_tpu_torch.hmm import cuda_viterbi as cv
    emits = cv.unpack_emits(comb_h[:, 8:])
    bounds = comb_h[:, :8].view(np.float32)[:, 3:7].astype(np.int32)
    out = []
    for r in range(comb_h.shape[0]):
        path = emits[r][emits[r] != cv.PAD_NIBBLE]
        trace = "".join("BMID"[c] for c in path[::-1])
        if not trace.startswith("B"):
            trace = "B" + trace
        out.append((trace + "E",) + tuple(int(b) for b in bounds[r]))
    return out


def check_k4(db, reads):
    """K4 on the inputs of one main-path batch: planes, score and argmin
    bit-equal to the plain version, and the host walk over the planes
    giving K1's state strings and bounds for every read."""
    import torch
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch.hmm import NGCL, ViterbiAligner
    from hmmufotu_tpu_torch.hmm import cuda_viterbi as cv
    from hmmufotu_tpu_torch.hmm.viterbi import MAX_REGIONS, traceback_packed
    al = ViterbiAligner(db.hmm, device="cuda")
    vp = pl.batch_find_seed_vpaths(db.hmm, db.csfm, reads, mode=NGCL)
    _, n_rows, codes, lengths, regions, _, _, comb = al.dispatch_batch(
        reads, vp)
    K = db.hmm.K
    tc, em, scal = al.staged
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()
    args = (tc, em, scal, to(codes), to(cv.make_meta(lengths, regions)),
            n_rows, K)
    got = cv.viterbi_planes_cuda(*args)
    want, plain_ms = cuda_once(lambda: cv.viterbi_planes_plain(*args))
    for name, a, b in zip(("score", "min_i", "min_j", "planes"), got, want):
        if a.shape != b.shape or a.dtype != b.dtype \
                or not torch.equal(a, b):
            raise AssertionError(f"K4: {name} differs from the plain "
                                 "version")
    score_h, mi_h, mj_h, packed_h = (x.cpu().numpy() for x in got)
    k1 = trace_strings(comb.cpu().numpy())
    finite = np.isfinite(score_h)
    bad = [r for r in np.nonzero(finite)[0]
           if traceback_packed(packed_h, r, int(mi_h[r]), int(mj_h[r]), K)
           != k1[r]]
    if bad or finite.sum() < 0.9 * len(reads):
        raise AssertionError(f"K4: host walk differs from K1's traceback "
                             f"for reads {bad[:8]} ({int(finite.sum())} "
                             "finite)")
    del want
    res = dict(ms=cuda_ms(lambda: cv.viterbi_planes_cuda(*args), 5),
               plain_ms=plain_ms,
               bytes=nbytes(*args[:5], got[3]) + 8 * 4 * len(reads),
               ops=K1_OPS_PER_CELL * dp_cells(args[4], n_rows, K,
                                              MAX_REGIONS),
               max_abs_err=0.0, plane_bytes=nbytes(got[3]))
    log(f"  K4: B={len(reads)} n_rows={n_rows} KPF={tc.shape[1]}: planes "
        f"({nbytes(got[3]) / 2**20:.0f} MiB), score and argmin bit-equal; "
        f"host walk equals K1's traceback for all {int(finite.sum())} "
        "finite reads")
    return res


def fp_iterate(eA, eB, n, p_init, skip, total):
    """(p, trips) of a K5 call by the plain iteration, a lane's terms
    summed by total: p each lane's result, trips the steps it takes (0 for
    a skipped lane)."""
    import torch
    from hmmufotu_tpu_torch.phylo.cuda_place import SAT_P
    from hmmufotu_tpu_torch.phylo.tree import BRANCH_EPS, MAX_ITER
    p = p_init.clone()
    done = skip.clone()
    trips = torch.zeros_like(p)
    for _ in range(MAX_ITER):
        if bool(done.all()):
            break
        trips += (~done).to(trips.dtype)
        num = eB * p[:, None]
        den = eA * (1.0 - p[:, None]) + num
        pn = total(torch.where(den > 0, num / den, 0.0)) / n
        bad = ~((pn >= 0) & (pn <= 1))
        diff = (torch.log1p(-pn) - torch.log1p(-p)).abs()
        conv = (diff < BRANCH_EPS) | ~torch.isfinite(diff) | (pn >= SAT_P)
        p = torch.where(done | bad, p, pn)
        done = done | conv | bad
    return p, trips


def fp_trips(eA, eB, n, p_init, skip):
    """Steps each lane of a K5 call takes (0 for a skipped lane), its
    terms summed in the kernel's order."""
    from hmmufotu_tpu_torch.phylo.cuda_fixed_point import tree_sum
    return fp_iterate(eA, eB, n, p_init, skip, tree_sum)[1]


def check_k5(call):
    """K5 against its plain version on the call of the fixed-point placer
    with the most lanes iterating; beside it, against the same iteration
    summed by torch's own reduction, which does not follow the kernel's
    order; and its chain floor, the time of one launch of the same inputs
    in which only the slowest lane iterates."""
    import torch
    from hmmufotu_tpu_torch.phylo import cuda_fixed_point as cf
    t0 = time.time()
    eA, eB, n, p_init, skip = call
    got = cf.fixed_point_cuda(*call)
    want, plain_ms = cuda_once(lambda: cf.fixed_point_plain(*call))
    err = (got - want).abs()
    if not bool(torch.isfinite(got).all()) \
            or bool((err > FP_ATOL + FP_RTOL * want.abs()).any()) \
            or not torch.equal(got[skip], p_init[skip].to(got.dtype)):
        raise AssertionError(f"K5 disagrees: max |dp| {float(err.max())}")
    live = ~skip
    n_live = int(live.sum())
    nf = n.to(torch.float32)
    trips = fp_trips(eA, eB, nf, p_init, skip)
    p_sum, trips_sum = fp_iterate(eA, eB, nf, p_init, skip,
                                  lambda x: x.sum(1))
    err_sum = (got - p_sum).abs()
    n_out = int((err_sum > FP_ATOL + FP_RTOL * p_sum.abs()).sum())
    sites = ((eA[live] > 0) | (eB[live] > 0)).sum(1).double()
    M, W = eA.shape
    res = dict(ms=cuda_ms(lambda: cf.fixed_point_cuda(*call), 20),
               plain_ms=plain_ms,
               # a live lane's two rows and n; skip, p_init and p of every
               # lane
               bytes=n_live * (2 * W * 4 + 4) + M * (1 + 4 + 4),
               ops=float((sites * trips[live].double()).sum())
               * FP_STEP_OPS,
               max_abs_err=float(err.max()))
    alone = torch.ones_like(skip)
    alone[int(torch.argmax(trips))] = False
    res["chain_ms"] = cuda_ms(
        lambda: cf.fixed_point_cuda(eA, eB, n, p_init, alone), 20)
    log(f"  K5: M={M} W={W} iterating lanes={n_live}: max |dp| "
        f"{float(err.max()):.3g}, p bit-equal {torch.equal(got, want)}, "
        f"trips mean "
        f"{float(trips[live].mean()) if n_live else 0:.2f} max "
        f"{int(trips.max())}; {res['ms']:.4f} ms, chain floor (the "
        f"slowest lane alone) {res['chain_ms']:.4f} ms; check "
        f"{time.time() - t0:.1f} s")
    log(f"  K5 against torch's sum over the sites: max |dp| "
        f"{float(err_sum.max()):.3g}, {n_out} lanes outside "
        f"{FP_ATOL:g} + {FP_RTOL:g} |p|, "
        f"{int((trips_sum != trips).sum())} stop on another trip")
    return res


def kernel_phase(db, reads):
    """Capture the kernels' inputs from one batch through each path and
    hold every kernel against its plain version on them.  Returns the
    per-kernel results and the main path's (alignments, best) of the
    batch."""
    import torch
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch.hmm import GLOBAL, ViterbiAligner
    calls, patch = capture_calls()
    with patch:
        main_run = run_assign(db, reads, "cuda", len(reads))
        # wide launch: 256 reads as unseeded full-DP reads
        al = ViterbiAligner(db.hmm, device="cuda")
        n_main = len(calls["viterbi"])
        h = al.dispatch_batch(reads[:256], None)
        n_wide = len(calls["viterbi"])
        # 5 region slots: 5' and 3' seed chains (GLOBAL seeding)
        vp = pl.batch_find_seed_vpaths(db.hmm, db.csfm, reads, mode=GLOBAL)
        al.dispatch_batch(reads, vp)
        torch.cuda.synchronize()
        del h
        # the fixed-point placer's K5 inputs (the aligner's mode does not
        # change them)
        run_assign(db, reads, "cuda", len(reads),
                   placer_kw=dict(sep_kernel=False, fp_kernel=True))
        torch.cuda.synchronize()
    v = calls["viterbi"]
    if not any(c[10] == 5 for c in v[n_wide:]):
        raise AssertionError("no K1 call with 5 region slots")
    if calls["est"] == [] or calls["sep"] == [] or calls["fp"] == []:
        raise AssertionError("placement kernels were not called")
    k1 = check_k1(v[:n_main], "main batch (3 regions)")
    check_k1(v[n_main:n_wide], "wide, full DP")
    check_k1(v[n_wide:], "GLOBAL seeds (5 regions)")
    if not any(c[8] < c[1].shape[1] for c in v[:n_main]):
        raise AssertionError("the main batch made no narrow launch")
    k2 = check_k2(calls["est"][0])
    k3 = check_k3(calls["sep"][0], "dGamma4")
    c = calls["sep"][0]
    ms1 = c[8].clone()
    ms1[40:48] = 0.0
    ms1[40] = 1.0
    check_k3(c[:8] + (ms1, 1), "1 rate")
    k5 = check_k5(calls["fp"][0][1])
    calls.clear()
    torch.cuda.empty_cache()
    k4 = check_k4(db, reads)
    return {"viterbi_traced": k1, "est": k2, "sep_optimize": k3,
            "viterbi_planes": k4, "fixed_point": k5}, main_run


def scale_launch_report(events, notes):
    """Log the main path's K1 launches by lane width and each K3 launch
    with its live lanes, trip counts and bound at that shape.  Returns the
    two lists of per-launch records."""
    k1 = [{"reads": B, "lanes": KP, "ms": s.elapsed_time(e)}
          for (s, e), (B, KP) in zip(events["viterbi_traced"],
                                     notes["viterbi_traced"])]
    from hmmufotu_tpu_torch.hmm.cuda_viterbi import _lanes_per_thread
    by_width = {}
    for rec in k1:
        by_width.setdefault(rec["lanes"], []).append(rec["ms"])
    log("[scale] K1 launches by lane width: " + "; ".join(
        f"{kp} lanes ({_lanes_per_thread(kp)[0]} a thread): {len(v)} "
        f"launches, mean {sum(v) / len(v):.3f} ms"
        for kp, v in sorted(by_width.items())))
    k3 = []
    for (s, e), (maskp, live, n_rates, outer, inner) in zip(
            events["sep_optimize"], notes["sep_optimize"]):
        lv = live.reshape(-1)
        n_bytes, ops = k3_work(sep_sites(maskp), lv, n_rates, outer, inner,
                               maskp.shape[1], lv.numel())
        b_ms, b_by = bound(n_bytes, ops)
        o, i = outer[lv], inner[lv]
        rec = {"lanes": lv.numel(), "live": int(lv.sum()),
               "outer_mean": float(o.mean()), "outer_max": int(o.max()),
               "inner_mean": float(i.mean()), "inner_max": int(i.max()),
               "ms": s.elapsed_time(e), "bound_ms": b_ms, "bound_by": b_by}
        k3.append(rec)
        log(f"[scale] K3 launch: {json.dumps(rec)}")
    return k1, k3


def scale_k1_checks(sdb, reads):
    """K1's launches of 4 and 8 lanes a thread on the scale DB, each held
    bit-equal to the plain version once: one batch of scale reads, every
    eighth unseeded, splits into a narrow launch and a full-width launch
    of the profile's KPF lanes (8 a thread at K = 6,000); the narrow
    launch's reads and band origins again at 2,048 lanes (4 a thread).
    Returns the per-launch records."""
    import torch
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch.hmm import NGCL, ViterbiAligner
    from hmmufotu_tpu_torch.hmm import cuda_viterbi as cv
    K = sdb.hmm.K
    vp = pl.batch_find_seed_vpaths(sdb.hmm, sdb.csfm, reads, mode=NGCL)
    for r in range(0, len(reads), 8):
        vp[r] = None
    calls, patch = capture_calls()
    with patch:
        ViterbiAligner(sdb.hmm, device="cuda").dispatch_batch(reads, vp)
        torch.cuda.synchronize()
    v = calls["viterbi"]
    KPF = v[0][1].shape[1]
    narrow = [c for c in v if c[8] < KPF]
    wide = [c for c in v if c[8] == KPF]
    if len(narrow) != 1 or len(wide) != 1:
        raise AssertionError(f"expected one narrow and one wide K1 launch, "
                             f"got lanes {[c[8] for c in v]}")
    c = narrow[0]
    _, max_steps, _ = cv.launch_shape(K, c[6], 2048)
    band4 = c[:8] + (2048, max_steps) + c[10:]
    out = []
    for label, call in (("full width", wide[0]), ("2,048-lane band", band4)):
        lpt, threads = cv._lanes_per_thread(call[8])
        res = check_k1([call], f"[scale] {label}, {lpt} lanes a thread x "
                               f"{threads} threads")
        out.append({"reads": call[3].shape[0], "lanes": call[8],
                    "lanes_a_thread": lpt, "threads": threads,
                    "ms": res["ms"], "plain_ms": res["plain_ms"],
                    "bit_equal": True})
    if sorted(r["lanes_a_thread"] for r in out) != [4, 8]:
        raise AssertionError(f"K1 launch shapes {out}")
    return out


def resident_phase(sdb, alns, full_best):
    """The window-resident placer (DevicePlacer(site_window=(s0, 1,024)),
    the single-card design for the gg_97 shape) on the scale reads whose
    placement window lies inside the site window, with f32 and with bf16
    message storage: its best placements against those of the full-width
    placer of the same storage by the near-tie rule, the first 64 against
    a CPU run of the same placer; the bf16 rows also against the f32 rows,
    every best loglik within BF16_LL_RTOL; peak device memory and resident
    bytes."""
    import torch
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
    tree = sdb.ptu
    s0 = max(0, (tree.cs_len - RESIDENT_COLS) // 3)
    s0 -= s0 % 128
    Ws = min(RESIDENT_COLS, tree.cs_len - s0)
    W = 512
    inside = [r for r, a in enumerate(alns)
              if a.is_valid() and full_best[r] is not None
              and a.cs_start - 1 >= s0
              and min(a.cs_end - 1, a.cs_start - 1 + W - 1) <= s0 + Ws - 1]
    if len(inside) < N_SCALE_CPU_READS:
        raise AssertionError(f"only {len(inside)} scale reads inside the "
                             f"site window [{s0}, {s0 + Ws})")
    sub = [alns[r] for r in inside]
    f32_rows = [full_best[r] for r in inside]

    def place(placer):
        rows = []
        for b0 in range(0, len(sub), BATCH):
            rows.extend(pl.assign_batch_device(tree, placer,
                                               sub[b0:b0 + BATCH]))
        return rows

    for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        want = f32_rows if dtype is None else place(
            DevicePlacer(tree, window=W, device="cuda", msg_dtype=dtype))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cnt = reset_counters()
        t = time.time()
        placer = DevicePlacer(tree, window=W, device="cuda", msg_dtype=dtype,
                              site_window=(s0, Ws))
        resident = nbytes(*(x for x in placer.dt if torch.is_tensor(x)))
        got = place(placer)
        torch.cuda.synchronize()
        dt = time.time() - t
        peak = torch.cuda.max_memory_allocated() - base
        launches = {k: cnt[k].n for k in ("est", "sep_optimize")}
        del placer
        ok, stats = compare_runs((sub, got), (sub, want), 0.25)
        log(f"[resident] {label} messages, site window [{s0}, {s0 + Ws}): "
            f"{len(sub)} in-window reads of {len(alns)} placed in {dt:.2f} "
            f"s (staging included), launches {launches}, resident "
            f"{resident / 2**30:.3f} GiB, peak device memory "
            f"{peak / 2**30:.2f} GiB beyond {base / 2**30:.2f} held; vs the "
            f"full-width {label} placer: {json.dumps(stats)}")
        if not ok or min(launches.values()) <= 0:
            raise AssertionError(f"the resident {label} placer disagrees "
                                 "with the full-width placer")
        cpu = DevicePlacer(tree, window=W, device="cpu", msg_dtype=dtype,
                           site_window=(s0, Ws))
        head = sub[:N_SCALE_CPU_READS]
        ok, stats = compare_runs(
            (head, got[:len(head)]),
            (head, pl.assign_batch_device(tree, cpu, head)), 0.25)
        del cpu
        log(f"[resident] {label}, first {len(head)} vs a CPU run of the "
            f"same placer: {json.dumps(stats)}")
        if not ok:
            raise AssertionError(f"the resident {label} placer disagrees "
                                 "with its CPU run")
        if dtype is None:
            continue
        # bf16 storage against f32: the candidates of nearly identical
        # sibling leaves swap places inside the rounding, so the nodes
        # are reported and the best logliks held to BF16_LL_RTOL
        _, stats = compare_runs((sub, got), (sub, f32_rows), 1.0,
                                ll_rtol=BF16_LL_RTOL)
        log(f"[resident] bf16 against the full-width f32 placer (loglik "
            f"rtol {BF16_LL_RTOL:g}): {json.dumps(stats)}")
        if stats["bad"] or stats["placed"] != len(sub):
            raise AssertionError("bf16 logliks outside their rounding "
                                 "bound")


# ---------------------------------------------------------------------------
# the assign CLI's batch loop: paired-end mates and chimera checking
# ---------------------------------------------------------------------------

def read_rows(path):
    """Body rows of an assignment TSV, split into fields."""
    with open(path) as fh:
        return [line.rstrip("\n").split("\t") for line in fh
                if not line.startswith("#") and not line.startswith("id\t")]


def compare_rows(gpu, cpu, max_node_frac):
    """compare_runs' rules on two assignment TSVs (no chimera columns):
    the same ids, alignment columns equal, the same branch and taxon, a
    differing row accepted only as a near tie, at most max_node_frac of
    the placed rows."""
    if [r[0] for r in gpu] != [r[0] for r in cpu]:
        return False, {"ids_differ": True}
    n_aln = n_diff = n_bad = n_placed = 0
    max_ll = 0.0
    for g, c in zip(gpu, cpu):
        n_aln += g[2:10] != c[2:10]        # coordinates, cost, alignment
        if (g[12] == "-1") != (c[12] == "-1"):
            n_bad += 1
            continue
        if c[12] == "-1":
            continue
        n_placed += 1
        if not all(math.isfinite(float(g[k])) for k in (11, 15, 16, 17)):
            n_bad += 1
        ll_g, ll_c = float(g[15]), float(c[15])
        if abs(ll_g - ll_c) > LL_ATOL + LL_RTOL * abs(ll_c):
            n_bad += 1
        if (g[10], g[12]) != (c[10], c[12]):
            n_diff += 1
            continue
        max_ll = max(max_ll, abs(ll_g - ll_c))
    ok = (n_aln == 0 and n_bad == 0 and n_placed > 0
          and n_diff <= max_node_frac * n_placed)
    return ok, dict(rows=len(gpu), aln_mismatch=n_aln, placed=n_placed,
                    node_mismatch_near_tie=n_diff, bad=n_bad,
                    max_loglik_diff=max_ll)


def run_cli(argv, device, out, chi):
    """The port's assign CLI writing `out` and `chi` (--chimera-out);
    returns their body rows."""
    from hmmufotu_tpu_torch.cli.assign import main as assign_main
    if assign_main(argv + ["-o", out, "--chimera-out", chi],
                   device=device) != 0:
        raise RuntimeError(f"assign on {device} failed")
    return read_rows(out), read_rows(chi)


def pair_files(insert):
    """The [pe] phase's directory and mate files for inserts of mean
    `insert`."""
    d = os.path.join(WORK, f"pe{insert}")
    return d, os.path.join(d, "pe_1.fasta"), os.path.join(d, "pe_2.fasta")


def pe_phase(fx, tree, n_pairs, insert):
    """Paired-end assign on n_pairs pairs of 150 bp mates from the port's
    sim (insert size mean `insert`, sd 20): on the card (launches counted
    from 0), then on the CPU, row for row."""
    import torch
    from hmmufotu_tpu_torch.cli.sim import main as sim_main
    d, r1, r2 = pair_files(insert)
    os.makedirs(d, exist_ok=True)
    if sim_main([fx, r1, "-m", r2, "-N", str(n_pairs), "-S", "11",
                 "--mean-size", str(insert), "--sd-size", "20", "-l",
                 "150"]) != 0:
        raise RuntimeError("sim failed")
    argv = [fx, r1, r2, "-S", "0", "-b", str(n_pairs)]
    cnt = reset_counters()
    t = time.time()
    gpu, gpu_chi = run_cli(argv, "cuda", os.path.join(d, "gpu.tsv"),
                           os.path.join(d, "gpu_chi.tsv"))
    torch.cuda.synchronize()
    dt = time.time() - t
    launches = {k: cnt[k].n for k in MAIN_KERNELS}
    W = min(512, tree.cs_len)
    n_wide = sum(int(r[7]) - int(r[6]) + 1 > W for r in gpu)
    log(f"[pe] {n_pairs} pairs (insert {insert} +- 20 bp, 150 bp mates) "
        f"through the assign CLI on the card in {dt:.2f} s "
        f"({n_pairs / dt:.1f} "
        f"pairs/s, DB load and strand test included); launches "
        f"{launches}; merged {len(gpu)}, badly oriented {len(gpu_chi)}; "
        f"merged reads wider than W = {W} columns: {n_wide}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    t = time.time()
    cpu, cpu_chi = run_cli(argv, "cpu", os.path.join(d, "cpu.tsv"),
                           os.path.join(d, "cpu_chi.tsv"))
    ok, stats = compare_rows(gpu, cpu, 0.01)
    stats["badly_oriented_equal"] = gpu_chi == cpu_chi
    log(f"[pe] vs the CPU run of the port ({time.time() - t:.1f} s): "
        f"{json.dumps(stats)}")
    if not ok or gpu_chi != cpu_chi or len(gpu) + len(gpu_chi) != n_pairs:
        raise AssertionError("paired-end run disagrees with the CPU run")


def chimera_phase(fx, tree):
    """assign -C on a contiguous chimera (5' of an archaeon, 3' of a
    bacterium at the same ungapped offset) and N_CHIMERA_CLEAN reads
    simulated from the bacterium, its clean control (tests/test_pipeline.py
    TestChimera), on the card and on the CPU: segment placement is host
    f64 in both, so the rows agree byte for byte.  The card run builds no
    DevicePlacer (its __init__ calls counted) and holds only the
    aligner's memory.  (Windows of the archaeon, an isolated leaf of this
    DB, are flagged at the default lod 0 by both packages: the reference
    algorithm's, not a fault.)"""
    import torch
    from evolved_inputs import simulate_reads
    from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
    d = os.path.join(WORK, "chimera")
    os.makedirs(d, exist_ok=True)
    leaves = [u for u in range(tree.num_nodes)
              if tree.is_leaf(u) and tree.msa_id[u] >= 0]
    u5 = next(u for u in leaves if tree.anno[u].startswith("k__Arch"))
    u3 = next(u for u in leaves if tree.anno[u].startswith("k__Bact"))

    def ungapped(u, lo, n):
        pos = np.nonzero(tree.seqs[u] >= 0)[0][lo:lo + n]
        return "".join("ACGT"[c] for c in tree.seqs[u][pos])

    recs = [("chimera", ungapped(u5, 10, 120) + ungapped(u3, 130, 120))]
    recs += [(f"clean{i}", s) for i, s in enumerate(simulate_reads(
        tree, np.random.default_rng(3), N_CHIMERA_CLEAN, leaves=[u3]))]
    reads = os.path.join(d, "chim.fasta")
    with open(reads, "w") as fh:
        fh.write("".join(f">{rid}\n{s}\n" for rid, s in recs))
    argv = [fx, reads, "-C", "-S", "0", "-s", "1"]
    built = []
    init = DevicePlacer.__init__

    def counted(placer, *a, **kw):
        built.append(1)
        init(placer, *a, **kw)

    DevicePlacer.__init__ = counted
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cnt = reset_counters()
    t = time.time()
    try:
        gpu = run_cli(argv, "cuda", os.path.join(d, "gpu.tsv"),
                      os.path.join(d, "gpu_chi.tsv"))
        torch.cuda.synchronize()
    finally:
        DevicePlacer.__init__ = init
    dt = time.time() - t
    peak = torch.cuda.max_memory_allocated() - held
    launches = {k: cnt[k].n for k in MAIN_KERNELS}
    t = time.time()
    cpu = run_cli(argv, "cpu", os.path.join(d, "cpu.tsv"),
                  os.path.join(d, "cpu_chi.tsv"))
    dt_cpu = time.time() - t
    flagged = sorted(r[0] for r in gpu[1])
    lod = {r[0]: float(r[14]) for r in gpu[0] + gpu[1]}
    clean = [v for k, v in lod.items() if k != "chimera" and math.isfinite(v)]
    log(f"[chimera] {len(recs)} reads through assign -C on the card in "
        f"{dt:.2f} s (CPU {dt_cpu:.2f} s); launches {launches}; flagged "
        f"{flagged}; main and chimera rows equal to the CPU run's: "
        f"{gpu == cpu}; lod of the chimera {lod.get('chimera', math.nan):g}, "
        f"largest of the clean reads {max(clean, default=math.nan):g}; "
        f"finite lods {sum(map(math.isfinite, lod.values()))} of {len(lod)}; "
        f"DevicePlacers built {len(built)}; device peak of the run "
        f"{peak / 2**30:.3f} GiB beyond the {held / 2**30:.3f} GiB held "
        "before it")
    if launches["viterbi_traced"] <= 0:
        raise AssertionError("assign -C did not launch K1")
    if built:
        raise AssertionError("assign -C built a DevicePlacer")
    if gpu != cpu or flagged != ["chimera"]:
        raise AssertionError("chimera run wrong or different from the CPU")


def evaluate_check(tree, want, budget_bytes=2 << 30, rtol=0.0,
                   sites=None):
    """The torch engine on the card against messages `want` (msg_up,
    msg_down, tree loglik) of the numpy engine on the same tree: the same
    -inf pattern, |delta| within EVAL_ATOL + rtol |value|, tree loglik
    within EVAL_LL_RTOL, and the device memory the engine allocates beyond
    what was held before it within budget_bytes.  The torch engine sweeps
    every site; with sites=(lo, hi) `want` holds the numpy engine's
    messages of those columns only (per-site independence makes them
    exact), and messages and loglik are compared there.  Returns (ok,
    stats, the torch run's messages)."""
    import copy
    import torch
    t = copy.copy(tree)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    t.evaluate(dtype=np.float32, engine="torch", budget_bytes=budget_bytes,
               device="cuda")
    torch.cuda.synchronize()
    dt = time.time() - t0
    # the engine's own peak: what it allocated beyond the tensors held
    # before it started
    peak = torch.cuda.max_memory_allocated() - base
    stats = dict(torch_s=dt, peak_gib=peak / 2**30,
                 budget_gib=budget_bytes / 2**30,
                 peak_within_budget=peak <= budget_bytes,
                 inf_pattern_equal=True,
                 max_abs_diff=0.0, max_rel_diff=0.0, outside=0,
                 not_finite=0)
    lo, hi = sites or (0, tree.cs_len)
    for a, b in zip((t.msg_up, t.msg_down), want[:2]):
        a, b = a[:, :, lo:hi], b[:, :, lo:hi]
        stats["inf_pattern_equal"] &= bool(
            ((a == -np.inf) == (b == -np.inf)).all())
        f = np.isfinite(b)
        err = np.abs(a[f].astype(np.float64) - b[f])
        mag = np.abs(b[f].astype(np.float64))
        stats["outside"] += int((err > EVAL_ATOL + rtol * mag).sum())
        stats["max_abs_diff"] = max(stats["max_abs_diff"], float(err.max()))
        stats["max_rel_diff"] = max(stats["max_rel_diff"], float(
            (err / np.maximum(mag, 1.0)).max()))
        stats["not_finite"] += int((~np.isfinite(a[f])).sum())
    ll = t.tree_loglik(lo, hi - 1)
    stats["loglik_rel_diff"] = abs(ll - want[2]) / abs(want[2])
    ok = (stats["inf_pattern_equal"] and stats["outside"] == 0
          and stats["not_finite"] == 0
          and stats["loglik_rel_diff"] < EVAL_LL_RTOL
          and stats["peak_within_budget"])
    return ok, stats, (t.msg_up, t.msg_down)


def evaluate_phase(tree):
    """The torch engine on the fixture tree against the numpy f64 engine,
    twice with several site blocks (bit-equal)."""
    import copy
    t = copy.copy(tree)
    t0 = time.time()
    t.evaluate()
    numpy_s = time.time() - t0
    want = (t.msg_up, t.msg_down, t.tree_loglik())
    runs = []
    for _ in range(2):
        ok, stats, msgs = evaluate_check(tree, want, budget_bytes=32 << 20)
        runs.append(msgs)
        if not ok:
            raise AssertionError(f"torch evaluate engine disagrees: {stats}")
    bit_equal = all(np.array_equal(a, b) for a, b in zip(*runs))
    stats["numpy_s"] = numpy_s
    stats["bit_equal_across_runs"] = bit_equal
    log(f"[evaluate] fixture tree ({tree.num_nodes} nodes x {tree.cs_len} "
        f"columns, K={len(tree._rates())}), torch engine on the card vs the "
        f"numpy f64 engine: {json.dumps(stats)}")
    if not bit_equal:
        raise AssertionError("two torch evaluate runs differ")


def sweep_timer():
    """(times, patch): while the patch is active, the wall time of every
    PTUnrooted.evaluate call is appended to times."""
    from hmmufotu_tpu_torch.phylo import PTUnrooted
    times, orig = [], PTUnrooted.evaluate

    def timed(tree, *a, **kw):
        t = time.time()
        out = orig(tree, *a, **kw)
        times.append(time.time() - t)
        return out
    return times, Patch((PTUnrooted, "evaluate", timed))


# ---------------------------------------------------------------------------
# the normal entry points: build -> DB files -> assign
# ---------------------------------------------------------------------------

def save_timers():
    """(seconds, patch): while the patch is active, the seconds of each
    npz file's save (MSA, CSFM index, tree) are stored under its
    suffix."""
    from hmmufotu_tpu_torch.index import CSFMIndex
    from hmmufotu_tpu_torch.msa import MSA
    from hmmufotu_tpu_torch.phylo import PTUnrooted
    secs, triples = {}, []
    for cls, suf in ((MSA, ".msa.npz"), (CSFMIndex, ".csfm.npz"),
                     (PTUnrooted, ".ptu.npz")):
        def timed(obj, path, _save=cls.save, _suf=suf):
            t = time.time()
            _save(obj, path)
            secs[_suf] = time.time() - t
        triples.append((cls, "save", timed))
    return secs, Patch(*triples)


def same_array(a, b) -> bool:
    """The same dtype, shape, order and bytes."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.flags.f_contiguous == b.flags.f_contiguous
            and a.tobytes("A") == b.tobytes("A"))


def db_file_checks(prefix, save_s):
    """Each npz file the build CLI wrote through the port's writer, three
    ways: every member carries its chunk table; zipfile's testzip() finds
    no bad member; the port's reader (every host core) and np.load (one
    zlib stream a member) give bit-equal arrays.  Logs each file's save
    and both loads' seconds and the threads the writer and reader use."""
    import zipfile
    from hmmufotu_tpu_torch.io.npz import NpzReader, chunk_table, host_threads
    out = {}
    for suf in (".msa.npz", ".csfm.npz", ".ptu.npz"):
        path = prefix + suf
        with zipfile.ZipFile(path) as z:
            infos = z.infolist()
            bad = z.testzip()
        t = time.time()
        with NpzReader(path) as r:
            got = {k: r[k] for k in r.files}
        port_s = time.time() - t
        t = time.time()
        with np.load(path, allow_pickle=False) as z:
            want = {k: z[k] for k in z.files}
        np_s = time.time() - t
        out[suf] = {
            "save_s": round(save_s[suf], 3),
            "bytes": os.path.getsize(path), "members": len(infos),
            "chunk_tables": sum(chunk_table(i) is not None for i in infos),
            "testzip_bad": bad, "port_load_s": round(port_s, 3),
            "np_load_s": round(np_s, 3),
            "bit_equal": sorted(got) == sorted(want) and all(
                same_array(got[k], want[k]) for k in want)}
        del got, want
    log(f"[cli] DB files (writer and reader on {host_threads()} threads): "
        f"{json.dumps(out)}")
    for suf, r in out.items():
        if r["chunk_tables"] != r["members"] or r["testzip_bad"] is not None \
                or not r["bit_equal"]:
            raise AssertionError(f"DB file {suf} fails its checks: {r}")


def cli_phase():
    """The build CLI writes an evolved DB of CLI_LEAVES leaves x
    SCALE_COLS columns to files (torch evaluate engine on the card); the
    assign CLI loads them on the card twice, with its default placer (the
    whole tree's messages on the card) and with --resident-window 1024,
    on N_CLI_READS amplicon reads from one 1,024-column region; launches
    counted from 0 for each run.  The first N_CLI_CPU_READS rows of each
    against a CPU run of the assign CLI: alignments equal, the same
    branch and taxon or a near tie on at most a quarter of the placed
    rows (the synthetic DBs' rule of [scale]).  Each npz file the build
    wrote is checked by db_file_checks."""
    import logging
    import torch
    from evolved_inputs import (FASTA, TAXONOMY, TREE, input_tree,
                                simulate_reads, synth_inputs, write_fasta)
    from torch_scale_assign import site_window
    from torch_scale_cli import (LogStamps, db_file_bytes, resident_oow,
                                 stage_seconds)
    from hmmufotu_tpu_torch.cli import setup_logging
    from hmmufotu_tpu_torch.cli.build import main as build_main
    d = os.path.join(WORK, "cli")
    t = time.time()
    n_nodes, _ = synth_inputs(d, CLI_LEAVES, SCALE_COLS)
    tree = input_tree(d)
    L = tree.cs_len
    r0, Wr = site_window(L, RESIDENT_COLS)
    reads = simulate_reads(tree, np.random.default_rng(8), N_CLI_READS,
                           region=(r0, r0 + Wr))
    del tree
    fa = write_fasta(os.path.join(d, "amplicon.fasta"), reads)
    fa_cpu = write_fasta(os.path.join(d, "amplicon_cpu.fasta"),
                         reads[:N_CLI_CPU_READS])
    log(f"[cli] inputs: {CLI_LEAVES} evolved leaves ({n_nodes} nodes) x "
        f"{SCALE_COLS} columns, {N_CLI_READS} amplicon reads of columns "
        f"[{r0}, {r0 + Wr}) in {time.time() - t:.1f} s")
    setup_logging(1)
    root = logging.getLogger()

    def stamped(fn):
        stamps = LogStamps()
        root.addHandler(stamps)
        try:
            return fn(), stamps.rows
        finally:
            root.removeHandler(stamps)

    prefix = os.path.join(d, "db")
    save_s, timers = save_timers()
    with timers:
        rc, rows = stamped(lambda: build_main([
            os.path.join(d, FASTA), os.path.join(d, TREE), "-a",
            os.path.join(d, TAXONOMY), "-n", prefix, "-s", "GTR",
            "--msg-dtype", "f32", "--eval-engine", "torch"]))
    if rc != 0:
        raise RuntimeError("build CLI failed")
    stages = {k: round(v, 2) for k, v in stage_seconds(rows).items()}
    log(f"[cli] build CLI stage seconds {json.dumps(stages)}; DB file "
        f"bytes {json.dumps(db_file_bytes(prefix))}")
    db_file_checks(prefix, save_s)
    t = time.time()
    cpu = cli_rows([prefix, fa_cpu], os.path.join(d, "cpu.tsv"), "cpu")
    log(f"[cli] assign CLI on the CPU, {len(cpu)} reads: "
        f"{time.time() - t:.1f} s")
    for flags in ([], ["--resident-window", str(RESIDENT_COLS)]):
        label = " ".join(flags) or "default (whole tree)"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cnt = reset_counters()
        t = time.time()
        gpu, rows = stamped(lambda: cli_rows(
            [prefix, fa] + flags, os.path.join(d, f"gpu{len(flags)}.tsv")))
        torch.cuda.synchronize()
        dt = time.time() - t
        launches = {k: cnt[k].n for k in MAIN_KERNELS}
        at = lambda head: [round(s, 2) for s, m in rows
                           if m.startswith(head)]
        log(f"[cli] assign {label} on the card: {len(gpu)} reads in "
            f"{dt:.2f} s (DB load and strand test included), seconds at "
            f"'Database loaded' {at('Database loaded')}, 'Processed' "
            f"{at('Processed')}; launches {launches}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"out of a {RESIDENT_COLS}-column resident window: "
            f"{json.dumps(resident_oow(gpu, L, RESIDENT_COLS))}")
        if min(launches.values()) <= 0:
            raise AssertionError(f"a kernel was not launched: {launches}")
        # the synthetic DBs' near-tie allowance (as in [scale]): short
        # sibling branches put candidates within f32 rounding of each
        # other, which the card and the CPU sum in different orders
        ok, stats = compare_rows(gpu[:len(cpu)], cpu, 0.25)
        log(f"[cli] {label}, first {len(cpu)} rows vs the CPU run: "
            f"{json.dumps(stats)}")
        if not ok or len(gpu) != N_CLI_READS:
            raise AssertionError(f"assign {label} disagrees with the CPU "
                                 f"run")


def gamma_phase():
    """BASELINE config #3's path at the [cli] phase's shape: the build CLI
    with -V (the dGamma4 rate mixture: a GTR evaluate, the alpha
    estimate, a second evaluate; torch engine on the card) on the [cli]
    phase's evolved inputs, then the assign CLI on the card with its
    default flags on the same N_CLI_READS amplicon reads, launches
    counted from 0; the loaded messages f32 (as the file stores them), 4
    rates on the placer; the first N_CLI_CPU_READS rows against a CPU
    run of the assign CLI (compare_rows, the synthetic DBs' near-tie
    rule)."""
    import logging
    import torch
    from evolved_inputs import FASTA, TAXONOMY, TREE
    from torch_scale_cli import BUILD_STAGES, LogStamps, stage_seconds
    from hmmufotu_tpu_torch.cli import setup_logging
    from hmmufotu_tpu_torch.cli.build import main as build_main
    from hmmufotu_tpu_torch.db import Database
    from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
    d = os.path.join(WORK, "cli")
    fa, fa_cpu = (os.path.join(d, f) for f in ("amplicon.fasta",
                                                "amplicon_cpu.fasta"))
    prefix = os.path.join(d, "db_gamma")
    setup_logging(1)
    stamps = LogStamps()
    root = logging.getLogger()
    root.addHandler(stamps)
    sweeps, patch = sweep_timer()
    t = time.time()
    try:
        with patch:
            rc = build_main([
                os.path.join(d, FASTA), os.path.join(d, TREE), "-a",
                os.path.join(d, TAXONOMY), "-n", prefix, "-s", "GTR", "-V",
                "-k", "4", "--msg-dtype", "f32", "--eval-engine", "torch"])
    finally:
        root.removeHandler(stamps)
    if rc != 0:
        raise RuntimeError("build CLI -V failed")
    stages = stage_seconds(stamps.rows, BUILD_STAGES[:4] + (
        ("evaluate_alpha", "Estimated dGamma alpha"),
        ("evaluate_dgamma", "Final tree log-likelihood")) + BUILD_STAGES[5:])
    alpha = [m for _, m in stamps.rows if m.startswith("Estimated dGamma")]
    log(f"[gamma] build CLI -V in {time.time() - t:.1f} s: "
        f"{alpha[-1] if alpha else 'no alpha estimated'}; stage seconds "
        f"{json.dumps({k: round(v, 2) for k, v in stages.items()})}; "
        f"evaluate sweeps {' + '.join(f'{x:.1f}' for x in sweeps)} s")
    if not alpha or len(sweeps) != 2:
        raise AssertionError("the build did not evaluate under dGamma4")
    held = {}
    load = vars(Database)["load"]           # the classmethod itself
    bound, init = Database.load, DevicePlacer.__init__

    def loading(path):
        held["db"] = bound(path)
        return held["db"]

    def placing(placer, *a, **kw):
        init(placer, *a, **kw)
        held["placer"] = placer

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cnt = reset_counters()
    t = time.time()
    Database.load = staticmethod(loading)
    try:
        with Patch((DevicePlacer, "__init__", placing)):
            gpu = cli_rows([prefix, fa], os.path.join(d, "gamma_gpu.tsv"))
    finally:
        Database.load = load
    torch.cuda.synchronize()
    dt = time.time() - t
    launches = {k: cnt[k].n for k in MAIN_KERNELS}
    msg_dtype = str(held["db"].ptu.msg_up.dtype)
    rates = int(held["placer"].dt.rates.numel())
    del held
    log(f"[gamma] assign on the card: {len(gpu)} reads in {dt:.2f} s (DB "
        f"load included); launches {launches}; loaded messages "
        f"{msg_dtype}, {rates} rates on the placer; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if msg_dtype != "float32" or rates != 4:
        raise AssertionError(f"loaded messages {msg_dtype}, {rates} rates")
    t = time.time()
    cpu = cli_rows([prefix, fa_cpu], os.path.join(d, "gamma_cpu.tsv"),
                   "cpu")
    ok, stats = compare_rows(gpu[:len(cpu)], cpu, 0.25)
    log(f"[gamma] first {len(cpu)} rows vs the CPU run "
        f"({time.time() - t:.1f} s): {json.dumps(stats)}")
    if not ok or len(gpu) != N_CLI_READS:
        raise AssertionError("assign -V DB disagrees with the CPU run")


def pe_cli_phase():
    """Paired-end assign (BASELINE config #4's path) on the DB files the
    [cli] phase wrote: N_CLI_PAIRS pairs from the port's sim CLI at its
    defaults (-l 250, fragments of 500 +- 30 columns from anywhere on the
    6,000), through the assign CLI on the card with launches counted from
    0, then the first N_CLI_CPU_PAIRS through it on the CPU: rows by
    compare_rows at the synthetic DBs' near-tie rule, the badly oriented
    pairs' rows equal."""
    import logging
    import torch
    from torch_scale_cli import LogStamps
    from hmmufotu_tpu_torch.cli.sim import main as sim_main
    from hmmufotu_tpu_torch.seq import SeqWriter, read_seqs
    d = os.path.join(WORK, "cli")
    prefix = os.path.join(d, "db")
    r1, r2 = os.path.join(d, "pe_1.fasta"), os.path.join(d, "pe_2.fasta")
    t = time.time()
    if sim_main([prefix, r1, "-m", r2, "-N", str(N_CLI_PAIRS), "-l",
                 "250"]) != 0:
        raise RuntimeError("sim failed")
    cpu_files = []
    for src in (r1, r2):
        dst = src.replace(".fasta", "_cpu.fasta")
        with SeqWriter(dst) as w:
            for rec in list(read_seqs(src))[:N_CLI_CPU_PAIRS]:
                w.write(rec)
        cpu_files.append(dst)
    ids = {rec.id for rec in read_seqs(cpu_files[0])}
    log(f"[pe] 6,000 columns: {N_CLI_PAIRS} pairs from the sim CLI at its "
        f"defaults in {time.time() - t:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps = LogStamps()
    root = logging.getLogger()
    root.addHandler(stamps)
    cnt = reset_counters()
    t = time.time()
    try:
        gpu, gpu_chi = run_cli([prefix, r1, r2], "cuda",
                               os.path.join(d, "pe_gpu.tsv"),
                               os.path.join(d, "pe_gpu_chi.tsv"))
        torch.cuda.synchronize()
    finally:
        root.removeHandler(stamps)
    dt = time.time() - t
    launches = {k: cnt[k].n for k in MAIN_KERNELS}
    loaded = [s for s, m in stamps.rows if m.startswith("Database loaded")]
    done = [s for s, m in stamps.rows if m.startswith("Processed")]
    loop_s = done[-1] - loaded[-1] if loaded and done else float("nan")
    W = 512
    spans = [int(r[7]) - int(r[6]) + 1 for r in gpu]
    n_wide = sum(w > W for w in spans)
    log(f"[pe] 6,000 columns: {N_CLI_PAIRS} pairs through the assign CLI "
        f"on the card in {dt:.2f} s (DB load and strand test included; "
        f"{loop_s:.2f} s from 'Database loaded' to the last 'Processed': "
        f"{N_CLI_PAIRS / loop_s:.1f} pairs/s); launches {launches}; "
        f"merged {len(gpu)}, badly oriented {len(gpu_chi)}; merged reads "
        f"wider than W = {W} columns: {n_wide} ({n_wide / len(gpu):.3f}), "
        f"widest {max(spans)}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    t = time.time()
    cpu, cpu_chi = run_cli([prefix] + cpu_files, "cpu",
                           os.path.join(d, "pe_cpu.tsv"),
                           os.path.join(d, "pe_cpu_chi.tsv"))
    gpu_sub = [r for r in gpu if r[0] in ids]
    gpu_chi_sub = [r for r in gpu_chi if r[0] in ids]
    # the synthetic DBs' near-tie allowance (as in [scale] and [cli])
    ok, stats = compare_rows(gpu_sub, cpu, 0.25)
    stats["badly_oriented_equal"] = gpu_chi_sub == cpu_chi
    log(f"[pe] 6,000 columns, first {N_CLI_CPU_PAIRS} pairs vs the CPU run "
        f"of the CLI ({time.time() - t:.1f} s): {json.dumps(stats)}")
    if not ok or gpu_chi_sub != cpu_chi \
            or len(gpu) + len(gpu_chi) != N_CLI_PAIRS \
            or len(cpu) + len(cpu_chi) != N_CLI_CPU_PAIRS:
        raise AssertionError("paired-end run on the 6,000-column DB "
                             "disagrees with the CPU run")


def merge_tree_check(tables, prefix, merged, nwk) -> dict:
    """merge -t of the OTU tables through the tree's topology alone: the
    npz members it reads are recorded (no message may be among them), and
    its newick is held byte-equal to one a whole Database.load gives.
    Returns the seconds of both merges."""
    from hmmufotu_tpu_torch.cli.merge import main as merge_main
    from hmmufotu_tpu_torch.db import Database
    from hmmufotu_tpu_torch.io.npz import NpzReader
    read, get, secs = [], NpzReader.__getitem__, {}

    def spy(z, key):
        read.append(os.path.basename(z.path) + ":" + key)
        return get(z, key)

    t = time.time()
    with Patch((NpzReader, "__getitem__", spy)):
        rc = merge_main(tables + ["-o", merged, "-db", prefix, "-t", nwk])
    if rc != 0:
        raise RuntimeError("merge failed")
    secs["merge"] = time.time() - t
    whole = nwk + ".whole"
    t = time.time()
    with Patch((Database, "load_topology",
                classmethod(lambda cls, p: cls.load(p).ptu))):
        rc = merge_main(tables + ["-o", merged + ".whole", "-db", prefix,
                                  "-t", whole])
    if rc != 0:
        raise RuntimeError("merge from a whole Database.load failed")
    secs["merge_whole_load"] = time.time() - t
    with open(nwk, "rb") as a, open(whole, "rb") as b:
        same_nwk = a.read() == b.read()
    msgs = [k for k in read if k.endswith((":msg_up", ":msg_down"))]
    log(f"[otu] merge -t read {read} in {secs['merge']:.2f} s (a whole "
        f"Database.load: {secs['merge_whole_load']:.2f} s); newick "
        f"byte-equal to the whole load's: {same_nwk}")
    if msgs or not same_nwk:
        raise AssertionError(f"merge -t read messages {msgs} or its newick "
                             f"differs from a whole load's ({same_nwk})")
    return secs


def otu_phase():
    """BASELINE config #5's path (assign -> sum -> merge) on the DB files
    the [cli] phase wrote: N_OTU_READS amplicon reads of the same region
    from another community (torch_scale_sum.py's sampler: OTU_LEAVES
    leaves with lognormal abundances, seed OTU_SEED) through the assign
    CLI on the card, launches counted from 0; then the sum CLI once a
    host with -l -c -t ([cli]'s default-placer TSV is host A, the new one
    host B) and merge -db -t.  Gates of torch_scale_sum.py: the merged
    table equals an independent count of the TSVs' rows by taxon, its
    total the assigned rows; one consensus record of the alignment's
    width an OTU of each host; the OTU tree names every merged OTU.
    merge -t reads no message member and writes the newick a whole
    Database.load gives."""
    import logging
    import torch
    from evolved_inputs import input_tree
    from torch_scale_assign import site_window
    from torch_scale_cli import LogStamps
    from torch_scale_sum import (communities, otu_gates, sample_reads,
                                 sum_argv, sum_outputs, write_sample)
    from hmmufotu_tpu_torch.cli.sum import main as sum_main
    d = os.path.join(WORK, "cli")
    prefix = os.path.join(d, "db")
    t = time.time()
    tree = input_tree(d)
    L = tree.cs_len
    r0, Wr = site_window(L, RESIDENT_COLS)
    region = (r0, r0 + Wr)
    comm = communities(tree, 1, 0, OTU_LEAVES, OTU_SEED, region)[0]
    reads, _ = sample_reads(tree, comm, N_OTU_READS, OTU_SEED, 1, region)
    del tree
    fa = write_sample(os.path.join(d, "s1.fasta"), 1, reads)
    log(f"[otu] second sample: {N_OTU_READS} amplicon reads of columns "
        f"[{r0}, {r0 + Wr}) from {len(comm)} leaves in "
        f"{time.time() - t:.1f} s")
    secs = {}
    torch.cuda.synchronize()
    stamps = LogStamps()
    root = logging.getLogger()
    root.addHandler(stamps)
    cnt = reset_counters()
    t = time.time()
    try:
        rows = cli_rows([prefix, fa], os.path.join(d, "s1.tsv"))
        torch.cuda.synchronize()
    finally:
        root.removeHandler(stamps)
    secs["assign"] = time.time() - t
    launches = {k: cnt[k].n for k in MAIN_KERNELS}
    loaded = [s for s, m in stamps.rows if m.startswith("Database loaded")]
    done = [s for s, m in stamps.rows if m.startswith("Processed")]
    stream_s = done[-1] - loaded[-1] if loaded and done else float("nan")
    log(f"[otu] assign on the card: {len(rows)} reads in "
        f"{secs['assign']:.2f} s (DB load and strand test included; "
        f"{stream_s:.2f} s from 'Database loaded' to the last 'Processed': "
        f"{N_OTU_READS / stream_s:.1f} reads/s); launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    tsvs = {"s0": os.path.join(d, "gpu0.tsv"), "s1": os.path.join(d,
                                                                  "s1.tsv")}
    outs = {}
    for h, name in (("A", "s0"), ("B", "s1")):
        outs[h] = sum_outputs(d, f"otu_{h}")
        t = time.time()
        if sum_main(sum_argv(prefix, {name: tsvs[name]}, outs[h])) != 0:
            raise RuntimeError(f"sum of host {h} failed")
        secs[f"sum_{h}"] = time.time() - t
    merged, nwk = os.path.join(d, "otu_merged.tsv"), os.path.join(
        d, "otu_merged.nwk")
    secs.update(merge_tree_check([outs["A"]["-o"], outs["B"]["-o"]], prefix,
                                 merged, nwk))
    gates = otu_gates(tsvs, {"s0": N_CLI_READS, "s1": N_OTU_READS}, outs,
                      merged, nwk, L)
    c = gates["count"]
    log(f"[otu] OTUs: host A {gates['consensus']['A']['otus']}, host B "
        f"{gates['consensus']['B']['otus']}, merged {c['merged_otus']} "
        f"({c['merged_total_reads']} reads); CLI seconds "
        f"{json.dumps({k: round(v, 2) for k, v in secs.items()})}; gates "
        f"{json.dumps(gates)}")
    if not gates["ok"]:
        raise AssertionError("the OTU tables disagree with the TSVs: "
                             f"{gates['fails']}")


# ---------------------------------------------------------------------------
# the parallel layer: meshes on the one card, two processes
# ---------------------------------------------------------------------------

def cli_rows(argv, out, device="cuda"):
    """The port's assign CLI writing `out`; returns its body rows."""
    from hmmufotu_tpu_torch.cli.assign import main as assign_main
    if assign_main(argv + ["-o", out], device=device) != 0:
        raise AssertionError(f"assign {' '.join(argv)} failed")
    return read_rows(out)


def parallel_cli(fx, fa, d):
    """assign --mesh and --mesh-tree on the fixture reads over the
    one-card mesh, launches counted from 0, rows against the CLI without
    a mesh.  Returns the one-process rows."""
    import torch
    # no -S: the deterministic seed pick, which several processes allow
    argv = [fx, fa, "-s", "1", "-b", str(N_FIXTURE_READS // 2)]
    t = time.time()
    plain = cli_rows(argv, os.path.join(d, "plain.tsv"))
    log(f"[parallel] CLI without a mesh: {len(plain)} rows in "
        f"{time.time() - t:.2f} s")
    for flag in ("--mesh", "--mesh-tree"):
        cnt = reset_counters()
        t = time.time()
        rows = cli_rows(argv + [flag], os.path.join(d, f"{flag[2:]}.tsv"))
        torch.cuda.synchronize()
        dt = time.time() - t
        launches = {k: cnt[k].n for k in MAIN_KERNELS}
        ok, stats = compare_rows(rows, plain, 0.01)
        log(f"[parallel] CLI {flag} over {torch.cuda.device_count()} "
            f"card(s): {len(rows)} reads in {dt:.2f} s (DB load in), "
            f"launches {launches}; vs the CLI without a mesh: "
            f"{json.dumps(stats)}")
        if min(launches.values()) <= 0:
            raise AssertionError(f"{flag}: a kernel was not launched: "
                                 f"{launches}")
        if not ok:
            raise AssertionError(f"{flag} rows disagree with the plain CLI")
    return plain


def parallel_scale(sdb, reads, n_shards=4):
    """Four shards on the one card at the scale shape: one batch of reads
    aligned on the card, placed by the single-device placer, by
    sharded_place_batch and by sharded_place_batch_tree + the host merge.
    Gates: tests/test_sharding.py's (the same c node, loglik within 1e-5
    relative; for the merge the same c and a nodes up to near ties, Q
    values within 0.05 or as q_close says), K2 and K3 once a shard."""
    import torch
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch.hmm import NGCL, ViterbiAligner
    from hmmufotu_tpu_torch.parallel import (sharded_place_batch,
                                             sharded_place_batch_tree)
    from hmmufotu_tpu_torch.parallel.sharding import Mesh, tree_shards
    from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
    tree = sdb.ptu
    alns = pl.align_reads(ViterbiAligner(sdb.hmm, device="cuda"), sdb.csfm,
                          reads, mode=NGCL)
    placer = DevicePlacer(tree, window=512, device="cuda")
    seqs, starts, ends, valid = pl._aln_windows(tree, placer, alns)
    ends = np.minimum(ends, starts + placer.W - 1)
    mesh = Mesh((torch.device("cuda", 0),) * n_shards)
    single = placer.place_batch_win(seqs, starts, ends,
                                    summary_only=True)["summary"]
    card = card_line()

    def timed(fn):
        fn()                                        # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cnt = reset_counters()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        dt = time.time() - t
        return out, dt, {k: cnt[k].n for k in ("est", "sep_optimize")}, \
            torch.cuda.max_memory_allocated()

    B = len(reads)
    data, dt, launches, peak = timed(lambda: sharded_place_batch(
        mesh, placer, seqs, starts, ends))
    rows = valid & (single[:, 11] > 0)
    same_c = bool((data[:, 0] == single[:, 0]).all())
    ll_rel = np.abs(data[rows, 5] - single[rows, 5]) \
        / np.maximum(np.abs(single[rows, 5]), 1e-30)
    n_bit = int((data == single).all(axis=1).sum())
    log(f"[parallel] scale, sharded_place_batch on {n_shards} shards of "
        f"one card ({card}): {B} reads in {dt:.3f} s ({B / dt:.1f} "
        f"reads/s), launches {launches}, peak device memory "
        f"{peak / 2**30:.2f} GiB; vs the single-device placement: same c "
        f"node on every row {same_c}, max loglik rel diff "
        f"{float(ll_rel.max(initial=0.0)):.3g}, rows bit-equal {n_bit} of "
        f"{B}")
    if not same_c or (ll_rel > 1e-5).any():
        raise AssertionError("sharded_place_batch disagrees with the "
                             "single-device placement")
    if launches != {"est": n_shards, "sep_optimize": n_shards}:
        raise AssertionError(f"sharded_place_batch launches {launches}")

    union, dt, launches, peak = timed(lambda: sharded_place_batch_tree(
        mesh, placer, seqs, starts, ends))
    shard_bytes = [nbytes(dt_l.msg_up, dt_l.msg_down)
                   for _, dt_l, _ in tree_shards(mesh, placer)]
    whole = nbytes(placer.dt.msg_up, placer.dt.msg_down)
    t = time.time()
    merged = pl.merge_mp_candidates(tree, union, valid, starts, ends,
                                    C=placer.C)
    dt_merge = time.time() - t
    n_tie = n_bad = n_q = n_q05 = 0
    for r, p in enumerate(merged):
        if p is None or not rows[r]:
            n_bad += (p is None) != (not rows[r])
            continue
        tol = 1e-5 * abs(single[r, 5])
        if abs(p.loglik - single[r, 5]) > tol:
            n_bad += 1
        if (p.c_node, p.a_node) != (int(single[r, 0]), int(single[r, 2])):
            n_tie += 1
            continue
        n_q += not (q_close(p.q_place, single[r, 6])
                    and q_close(p.q_taxon, single[r, 7]))
        n_q05 += (abs(p.q_place - single[r, 6]) > Q_ATOL
                  or abs(p.q_taxon - single[r, 7]) > Q_ATOL)
    log(f"[parallel] scale, sharded_place_batch_tree on {n_shards} shards "
        f"of one card ({card}): {B} reads in {dt:.3f} s ({B / dt:.1f} "
        f"reads/s), host merge {dt_merge:.3f} s, launches {launches}, peak "
        f"device memory {peak / 2**30:.2f} GiB; message bytes a shard "
        f"{shard_bytes} of {whole} whole; vs the single-device placement: "
        f"rows {int(rows.sum())}, c/a node near ties {n_tie}, loglik or "
        f"placed-ness off {n_bad}, Q values off by > {Q_ATOL} {n_q05}, of "
        f"them with error probabilities more than {Q_ULPS} f32 ulps of 1 "
        f"apart {n_q}")
    if n_bad or n_q or n_tie > 0.01 * rows.sum():
        raise AssertionError("the tree-sharded merge disagrees with the "
                             "single-device placement")
    if launches != {"est": n_shards, "sep_optimize": n_shards}:
        raise AssertionError(f"sharded_place_batch_tree launches "
                             f"{launches}")


def q_close(a: float, b: float) -> bool:
    """Two Q values (-10 log10(1 - posterior)) within Q_ATOL, or whose
    error probabilities 1 - posterior are within Q_ULPS f32 ulps of 1:
    the posterior is an f32 near 1, so at Q ~ 50 (1 - post ~ 1e-5) one
    ulp of 1 (1.2e-7) moves Q by ~0.05, and the host merge and the card
    sum the weights in different orders."""
    return (abs(a - b) <= Q_ATOL
            or abs(10 ** (-a / 10) - 10 ** (-b / 10)) <= Q_ULPS * 2 ** -23)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parallel_processes(fx, reads, d, plain, tag, rebuild=False):
    """assign --num-processes 2 over gloo on the read files `reads` (one:
    single-end; two: pairs, through the batch loop): the data rows must
    equal the one-process run's (`plain`) byte for byte.  On one card
    both processes share it; with two cards or more each process sees
    its own (CUDA_VISIBLE_DEVICES).  rebuild: from a build directory
    whose libraries were just removed, so both processes build at once,
    one compiles while the other waits."""
    import torch
    from hmmufotu_tpu_torch import _cuda
    if rebuild:
        for name in _cuda.KERNEL_SOURCES:
            path = _cuda._lib_path(name)
            if os.path.exists(path):
                os.remove(path)
    out = os.path.join(d, f"multi_{tag}.tsv")
    aln = os.path.join(d, f"aln_{tag}.fa")
    port = free_port()
    argv = [fx, *reads, "-s", "1", "-b", str(N_FIXTURE_READS // 2), "-o",
            out, "-a", aln, "--coordinator", f"localhost:{port}",
            "--num-processes", "2"]
    own_card = torch.cuda.device_count() >= 2
    envs = [dict(os.environ, PYTHONPATH=REPO,
                 **({"CUDA_VISIBLE_DEVICES": str(pid)} if own_card else {}))
            for pid in (0, 1)]
    cards = ("cards 0 and 1, one a process (CUDA_VISIBLE_DEVICES)"
             if own_card else "card 0, shared")
    t = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "import sys; from hmmufotu_tpu_torch.cli.assign import main; "
         f"sys.exit(main({argv + ['--process-id', str(pid)]!r}))"],
        cwd=REPO, env=envs[pid], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in (0, 1)]
    try:
        res = [p.communicate(timeout=600) + (p.returncode,) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    dt = time.time() - t
    for pid, (_, err, rc) in enumerate(res):
        if rc != 0:
            raise AssertionError(f"process {pid} failed ({rc}):\n"
                                 f"{err[-3000:]}")
    rows = read_rows(out)
    files = [os.path.exists(f"{aln}.p{pid}") for pid in (0, 1)]
    built = all(os.path.exists(_cuda._lib_path(n))
                for n in _cuda.KERNEL_SOURCES)
    log(f"[parallel] assign --num-processes 2, {tag}, on {cards}: "
        f"{len(rows)} rows in {dt:.1f} s (two processes, each importing "
        f"torch and loading the DB"
        + (", both building the kernels from an empty build directory"
           if rebuild else "")
        + f"); rows byte-equal to the one-process run: {rows == plain}; "
        f"--align-out .p0/.p1 present {files}; libraries built {built}")
    if rows != plain or not plain or not all(files) or not built:
        raise AssertionError(f"the two-process run ({tag}) differs from "
                             "one process")


def parallel_phase(fx, fx_reads, sdb, s_reads):
    from evolved_inputs import write_fasta
    d = os.path.join(WORK, "parallel")
    os.makedirs(d, exist_ok=True)
    fa = write_fasta(os.path.join(d, "reads.fasta"), fx_reads)
    t = time.time()
    plain = parallel_cli(fx, fa, d)
    parallel_scale(sdb, s_reads[:BATCH])
    parallel_processes(fx, [fa], d, plain, "single-end", rebuild=True)
    # the [pe] phase's N_PAIRS fixture pairs, through the batch loop
    _, *pe = pair_files(400)
    plain_pe = cli_rows([fx, *pe, "-s", "1", "-b",
                         str(N_FIXTURE_READS // 2)],
                        os.path.join(d, "plain_pe.tsv"))
    parallel_processes(fx, pe, d, plain_pe, "paired-end")
    log(f"[parallel] phase took {time.time() - t:.1f} s")


# ---------------------------------------------------------------------------
# BASELINE configs #1-#2: the independent oracle, assign's flags, models
# ---------------------------------------------------------------------------

def oracle_phase():
    """The oracle's goldens through the port's build, sim, assign (on the
    card) and jplace CLIs, by TestGoldenCategories' checks; then
    N_ORACLE_SE JC69 reads and N_ORACLE_PE GTR+dGamma4 pairs through the
    port on the card against the independent f64 oracle (tests/oracle/,
    in a process a core), by scripts/torch_run_parity.py's rules and
    exit rules.  K1-K3 launches counted from 0 for each run."""
    import torch
    import torch_run_parity as trp
    d = os.path.join(WORK, "oracle")
    for name in ("assign", "jplace"):
        cnt = reset_counters()
        t = time.time()
        r = getattr(trp, f"golden_{name}")(os.path.join(d, name), "cuda")
        torch.cuda.synchronize()
        launches = {k: cnt[k].n for k in MAIN_KERNELS}
        log(f"[oracle] golden {name}: {r['n'] - len(r['failures'])}/"
            f"{r['n']} of the oracle's reads agree, {r['rows']} rows, in "
            f"{time.time() - t:.1f} s (build, sim, assign); launches "
            f"{launches}; failures {r['failures']}")
        if r["failures"] or r["rows"] != r["n"] \
                or min(launches.values()) <= 0:
            raise AssertionError(f"golden {name} disagrees")
    for model, dgamma, paired, tag, n, seed in (
            ("JC69", False, False, "JC69-SE", N_ORACLE_SE, 11),
            ("GTR", True, True, "GTR-dG4-PE", N_ORACLE_PE, 13)):
        cnt = reset_counters()
        s = trp.run_sweep(d, model, dgamma, n, seed, paired, tag, "cuda",
                          os.cpu_count() or 1, host_n=N_ORACLE_HOST)
        launches = {k: cnt[k].n for k in MAIN_KERNELS}
        fails = trp.failures(s)
        log(f"[oracle] {tag} against the f64 oracle: {json.dumps(s)}; "
            f"launches {launches}; failures {fails}")
        if fails or min(launches.values()) <= 0:
            raise AssertionError(f"{tag} disagrees with the oracle")


def build_in_processes(specs):
    """The build CLI of each (prefix, sub-model, extra arguments) spec on
    the fixture, each in a process of its own, all at once."""
    procs = []
    try:
        for prefix, model, extra in specs:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "hmmufotu_tpu_torch.cli.build",
                 os.path.join(FIXTURES, "70_otus.fasta"),
                 os.path.join(FIXTURES, "70_otus.tree"), "-a",
                 os.path.join(FIXTURES, "70_otus_taxonomy.txt"), "-n",
                 prefix, "-s", model, *extra], cwd=REPO,
                env=dict(os.environ, PYTHONPATH=REPO),
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True))
        errs = [(p.communicate(timeout=600)[1], p.returncode)
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (prefix, _, _), (err, rc) in zip(specs, errs):
        if rc != 0:
            raise RuntimeError(f"build {prefix} failed ({rc}):\n"
                               f"{err[-3000:]}")


def cpu_assign(argv):
    """The assign CLI on the CPU in a pool worker, one torch thread."""
    import torch
    from hmmufotu_tpu_torch.cli.assign import main as assign_main
    torch.set_num_threads(1)
    return assign_main(argv, device="cpu")


def flag_rows_agree(gpu, cpu, flags, n_reads):
    """tests/test_torch_cli_flags.py's rules on two runs' (rows, chimera
    rows): with -C both byte-equal; else the same ids, alignment columns
    equal, every row's branch and taxon the same but at most one near tie
    (logliks within LL_ATOL + LL_RTOL |ll|), at most two reads
    unplaced; --align-only rows equal."""
    (g_rows, g_chi), (c_rows, c_chi) = gpu, cpu
    if "-C" in flags:
        ok = (g_rows == c_rows and g_chi == c_chi
              and len(g_rows) + len(g_chi) == n_reads)
        return ok, dict(rows=len(g_rows), chimera_rows=len(g_chi),
                        byte_equal=g_rows == c_rows and g_chi == c_chi)
    n_aln = n_near = n_bad = 0
    max_ll = 0.0
    for g, c in zip(g_rows, c_rows):
        n_aln += g[2:10] != c[2:10] or len(g) != len(c)
        if "--align-only" in flags:
            n_bad += g[10:] != c[10:]
            continue
        if c[10] != "-1":
            dll = abs(float(g[15]) - float(c[15]))
            n_bad += dll > LL_ATOL + LL_RTOL * abs(float(c[15]))
            max_ll = max(max_ll, dll)
        n_near += (g[10], g[12], g[13]) != (c[10], c[12], c[13])
    placed = sum(r[10] != "-1" for r in g_rows)
    ok = ([r[0] for r in g_rows] == [r[0] for r in c_rows]
          and len(g_rows) == n_reads and g_chi == c_chi and n_aln == 0
          and n_bad == 0 and n_near <= 1
          and ("--align-only" in flags or placed >= n_reads - 2))
    return ok, dict(rows=len(g_rows), aln_mismatch=n_aln, placed=placed,
                    near_ties=n_near, bad=n_bad, max_loglik_diff=max_ll)


def flags_phase():
    """assign's flags and the substitution models on the card against the
    CPU.  The fixture's GTR DB and the other models' DBs come from the
    build CLI, each in its own process, all at once.  The N_FLAG_READS
    reads of tests/test_torch_cli_flags.py (seed 4) run with each of
    FLAG_SETS, then N_MODEL_READS reads (seed 5) on each model's DB
    without flags; every run with -S 0 -s 1 through the assign CLI on
    the card (launches counted from 0) and on the CPU (pool workers, at
    the same time), the rows by flag_rows_agree."""
    import multiprocessing
    import torch
    from evolved_inputs import simulate_reads, write_fasta
    from hmmufotu_tpu_torch.db import Database
    d = os.path.join(WORK, "flags")
    os.makedirs(d, exist_ok=True)
    t = time.time()
    dbs = {(m, tuple(x)): os.path.join(d, f"70_otus_{m}{''.join(x)}")
           for m, x in MODEL_SETS}
    build_in_processes([(p, m, list(x)) for (m, x), p in dbs.items()])
    t_build = time.time() - t
    gtr = dbs[("GTR", ())]
    runs = []                   # (label, flags, db, reads, n)
    fa = write_fasta(os.path.join(d, "flags.fasta"), simulate_reads(
        Database.load(gtr).ptu, np.random.default_rng(4), N_FLAG_READS))
    runs += [(" ".join(f), f, gtr, fa, N_FLAG_READS) for f in FLAG_SETS]
    for (m, x), p in dbs.items():
        fa = write_fasta(p + "_reads.fasta", simulate_reads(
            Database.load(p).ptu, np.random.default_rng(5), N_MODEL_READS))
        runs.append((f"-s {m}{' ' + ' '.join(x) if x else ''}", [], p, fa,
                     N_MODEL_READS))

    def argv(i, tag):
        _, flags, db, fa, _ = runs[i]
        return [db, fa, "-S", "0", "-s", "1", *flags, "-o",
                os.path.join(d, f"{i}_{tag}.tsv"), "--chimera-out",
                os.path.join(d, f"{i}_{tag}_chi.tsv")]

    def rows(i, tag):
        return (read_rows(os.path.join(d, f"{i}_{tag}.tsv")),
                read_rows(os.path.join(d, f"{i}_{tag}_chi.tsv")))

    from hmmufotu_tpu_torch.cli.assign import main as assign_main
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(len(runs), max(1, (os.cpu_count() or 2) - 1))) as pool:
        t = time.time()
        cpu_rcs = pool.map_async(cpu_assign, [argv(i, "cpu")
                                              for i in range(len(runs))])
        failed = []
        for i, (label, flags, _, _, n) in enumerate(runs):
            cnt = reset_counters()
            t1 = time.time()
            if assign_main(argv(i, "gpu"), device="cuda") != 0:
                raise AssertionError(f"assign {label} failed on the card")
            torch.cuda.synchronize()
            launches = {k: cnt[k].n for k in MAIN_KERNELS}
            runs[i] += (launches, time.time() - t1)
        t_gpu = time.time() - t
        rcs = cpu_rcs.get(timeout=900)
        t_cpu = time.time() - t
    if any(rcs):
        raise AssertionError(f"assign on the CPU failed: {rcs}")
    for i, (label, flags, _, _, n, launches, dt) in enumerate(runs):
        ok, stats = flag_rows_agree(rows(i, "gpu"), rows(i, "cpu"), flags,
                                    n)
        need = ["viterbi_traced"] if "-C" in flags \
            or "--align-only" in flags else list(MAIN_KERNELS)
        ok = ok and all(launches[k] > 0 for k in need)
        log(f"[flags] {label}: {n} reads on the card in {dt:.2f} s, "
            f"launches {launches}; vs the CPU: {json.dumps(stats)}"
            f"{'' if ok else ' FAILED'}")
        if not ok:
            failed.append(label)
    log(f"[flags] {len(FLAG_SETS)} flag sets and {len(MODEL_SETS)} model "
        f"DBs: builds {t_build:.1f} s (one process each, at once), card "
        f"runs {t_gpu:.1f} s, CPU runs done {t_cpu:.1f} s after they "
        f"began (pool workers beside the card runs); failed {failed}")
    if failed:
        raise AssertionError(f"card and CPU disagree: {failed}")


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "hmmufotu_tpu_torch")):
        print("chip_smoke: run from the repository root (package "
              "hmmufotu_tpu_torch not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from evolved_inputs import simulate_reads
    t_all = time.time()
    device_name = torch.cuda.get_device_name(0)
    phase_s, last = {}, [t_all]

    def lap():
        # seconds since the previous phase ended
        now = time.time()
        last[0], dt = now, now - last[0]
        return round(dt, 1)

    # ---- 1. card ---------------------------------------------------------
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {device_name} count "
        f"{torch.cuda.device_count()}")

    phase_s["card"] = lap()

    # ---- 2. build --------------------------------------------------------
    from hmmufotu_tpu_torch import _cuda
    t = time.time()
    out = _cuda.build_all()
    log(f"[build] kernels built in {time.time() - t:.1f} s")
    for line in out.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  " + line.strip())

    phase_s["build"] = lap()

    # ---- 3. fixture DB ---------------------------------------------------
    os.makedirs(WORK, exist_ok=True)
    fx = os.path.join(WORK, "70_otus")
    log(f"[fixture] 70_otus GTR+dGamma4 DB built in "
        f"{build_fixture_db(fx):.1f} s")
    db = load_db(fx)
    reads = simulate_reads(db.ptu, np.random.default_rng(0), BATCH)

    phase_s["fixture"] = lap()

    # ---- 4. kernels against their plain versions -------------------------
    t = time.time()
    log("[kernels] inputs captured from one main-path batch of "
        f"{BATCH} reads")
    kres, main_run = kernel_phase(db, reads)
    torch.cuda.synchronize()
    log(f"[kernels] all kernels agree with their plain versions "
        f"({time.time() - t:.1f} s)")

    phase_s["kernels"] = lap()

    # ---- 5. fixture main path on the card vs a CPU run -------------------
    fx_reads = reads[:N_FIXTURE_READS]
    run_assign(db, fx_reads[:64], "cuda", 64)               # warm-up
    torch.cuda.synchronize()
    cnt = reset_counters()
    t = time.time()
    gpu = run_assign(db, fx_reads, "cuda", N_FIXTURE_READS // 2)
    torch.cuda.synchronize()
    dt = time.time() - t
    fx_launches = {k: cnt[k].n for k in MAIN_KERNELS}
    log(f"[assign] fixture: {len(fx_reads)} reads on the card in "
        f"{dt:.2f} s ({len(fx_reads) / dt:.1f} reads/s), launches "
        f"{fx_launches}")
    if min(fx_launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {fx_launches}")
    t = time.time()
    cpu = run_assign(db, fx_reads, "cpu", N_FIXTURE_READS // 2)
    ok, stats = compare_runs(gpu, cpu, 0.01)
    log(f"[assign] fixture vs CPU run of the port ({time.time() - t:.1f} "
        f"s): {json.dumps(stats)}")
    if not ok:
        raise AssertionError("fixture run disagrees with the CPU run")


    phase_s["assign"] = lap()

    # ---- 6. the second path: host traceback (K4) + fixed-point placer
    # (K5), one batch of the full width, against the main path ----------
    mode_kw = dict(aligner_kw=dict(traceback_mode="host"),
                   placer_kw=dict(sep_kernel=False, fp_kernel=True))
    run_assign(db, reads[:64], "cuda", 64, **mode_kw)         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cnt = reset_counters()
    events, notes, patch = event_timers()
    with patch:
        t = time.time()
        modes = run_assign(db, reads, "cuda", BATCH, **mode_kw)
        torch.cuda.synchronize()
        dt = time.time() - t
    mode_launches = {k: cnt[k].n for k in MODE_KERNELS}
    mode_ms = {k: sum(s.elapsed_time(e) for s, e in events[k])
               for k in MODE_KERNELS}
    mode_peak = torch.cuda.max_memory_allocated()
    log(f"[modes] host-traceback aligner + fixed-point placer: "
        f"{len(reads)} reads in one batch of {BATCH} in {dt:.2f} s "
        f"({len(reads) / dt:.1f} reads/s); launches "
        f"{ {k: c.n for k, c in cnt.items()} }; kernel time ms "
        f"{json.dumps({k: round(v, 3) for k, v in mode_ms.items()})}; "
        f"planes downloaded per batch "
        f"{kres['viterbi_planes']['plane_bytes']} bytes; peak device "
        f"memory {mode_peak / 2**30:.2f} GiB")
    if min(mode_launches.values()) <= 0:
        raise AssertionError(f"a kernel of the second path was not "
                             f"launched: {mode_launches}")
    if any(cnt[k].n for k in MAIN_KERNELS):
        raise AssertionError("the second path launched a main-path kernel")
    ok, stats = compare_runs(modes, main_run, 0.01)
    log(f"[modes] vs the main path, read for read: {json.dumps(stats)}")
    if not ok:
        raise AssertionError("the second path disagrees with the main path")
    stages = batch_stages(db, reads, "dp_s", "download_walk_strings_s",
                          **mode_kw)
    log(f"[modes] stages of the same batch, host clock: "
        f"{json.dumps(stages)}")
    sub = reads[:N_MODE_READS]
    main_sub = (main_run[0][:len(sub)], main_run[1][:len(sub)])
    for label, kw, cost_rtol in (
            ("scan aligner (host traceback)",
             dict(aligner_kw=dict(kernel="scan")), 1e-6),
            ("scan aligner (device traceback)",
             dict(aligner_kw=dict(kernel="scan", traceback_mode="device")),
             1e-6),
            ("K3 fed by the tensor-op estimate",
             dict(placer_kw=dict(sep_kernel=True, est_kernel=False)), 0.0),
            ("tensor-op optimize, tensor-op fixed point",
             dict(placer_kw=dict(sep_kernel=False, fp_kernel=False)), 0.0)):
        t = time.time()
        out = run_assign(db, sub, "cuda", len(sub), **kw)
        torch.cuda.synchronize()
        ok, stats = compare_runs(out, main_sub, 0.05, cost_rtol)
        log(f"[modes] {label}: {len(sub)} reads in {time.time() - t:.2f} "
            f"s, vs the main path: {json.dumps(stats)}")
        if not ok:
            raise AssertionError(f"{label} disagrees with the main path")

    phase_s["modes"] = lap()

    # ---- 7-9. the assign CLI's batch loop; the torch evaluate engine ----
    t = time.time()
    pe_phase(fx, db.ptu, N_PAIRS, 400)
    # inserts of 600 bp: merged reads wider than the placer's window
    pe_phase(fx, db.ptu, N_WIDE_PAIRS, 600)
    log(f"[pe] phase took {time.time() - t:.1f} s")
    t = time.time()
    chimera_phase(fx, db.ptu)
    log(f"[chimera] phase took {time.time() - t:.1f} s")
    t = time.time()
    evaluate_phase(db.ptu)
    log(f"[evaluate] phase took {time.time() - t:.1f} s")

    phase_s["pe+chimera+evaluate"] = lap()

    # ---- 10. realistic size: the gg_97 shape's 6,000 columns ------------
    t_scale = time.time()
    sweeps, patch = sweep_timer()
    with patch:
        sdb, n_nodes, max_depth, t_gen, t_build = build_synth_db(
            os.path.join(WORK, "synth"), SCALE_LEAVES, SCALE_COLS)
    log(f"[scale] synthetic DB: {SCALE_LEAVES} leaves ({n_nodes} nodes, "
        f"depth {max_depth}) x {SCALE_COLS} columns, GTR+dGamma4; "
        f"inputs {t_gen:.1f} s, build {t_build:.1f} s, of it the torch "
        f"evaluate sweeps on the card "
        f"{' + '.join(f'{x:.1f}' for x in sweeps)} s "
        f"({sum(sweeps) / t_build:.1%})")
    log("reduced " + json.dumps({
        "from": "gg_97 shape: 149,999 nodes x 6,000 columns",
        "to": f"{n_nodes} nodes x {SCALE_COLS} columns",
        "why": "the host CSFM build of the gg_97 shape's 405M-character "
               "concatenation takes 8 to 19 min (BASELINE.md), beyond this "
               "run's time limit beside its other phases; the columns are "
               "not cut"}))
    log(f"[scale] K={sdb.hmm.K} csLen={sdb.ptu.cs_len} nodes="
        f"{sdb.ptu.num_nodes}")
    s_reads = simulate_reads(sdb.ptu, np.random.default_rng(1),
                             N_SCALE_READS)
    run_assign(sdb, s_reads[:BATCH], "cuda", BATCH)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cnt = reset_counters()
    events, notes, patch = event_timers()
    with patch:
        t = time.time()
        sgpu = run_assign(sdb, s_reads, "cuda", BATCH)
        torch.cuda.synchronize()
        dt = time.time() - t
    launches = {k: cnt[k].n for k in MAIN_KERNELS}
    kernel_ms = {k: sum(s.elapsed_time(e) for s, e in events[k])
                 for k in MAIN_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    # the launch report's references keep earlier batches' K3 masks alive
    held = nbytes(*(n[0] for n in notes["sep_optimize"][:-1]))
    n_placed = sum(b is not None for b in sgpu[1])
    log(f"[scale] {len(s_reads)} reads in {dt:.2f} s: "
        f"{len(s_reads) / dt:.1f} reads/s, {n_placed} placed; launches "
        f"{launches}; kernel time ms "
        f"{json.dumps({k: round(v, 3) for k, v in kernel_ms.items()})}; "
        f"peak device memory {peak / 2**30:.2f} GiB, at most "
        f"{held / 2**30:.2f} GiB of it K3 masks kept for the launch report")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    t = time.time()
    scale_k1, scale_k3 = scale_launch_report(events, notes)
    del events, notes
    if n_placed < 0.9 * len(s_reads):
        raise AssertionError(f"only {n_placed} reads placed")
    scale_k1_shapes = scale_k1_checks(sdb, s_reads[:BATCH // 8])
    stages = batch_stages(sdb, s_reads[:BATCH], "dp_dispatch_s",
                          "download_strings_s")
    log(f"[scale] stages of one batch of {BATCH}, host clock, device "
        f"drained between them: {json.dumps(stages)}")
    log(f"[scale] launch report, K1 shapes and stages took "
        f"{time.time() - t:.1f} s")
    t = time.time()
    sub = s_reads[:N_SCALE_CPU_READS]
    ok, stats = compare_runs(
        (sgpu[0][:len(sub)], sgpu[1][:len(sub)]),
        run_assign(sdb, sub, "cpu", len(sub)), 0.25)
    log(f"[scale] first {len(sub)} reads vs CPU run of the port "
        f"({time.time() - t:.1f} s): {json.dumps(stats)}")
    if not ok:
        raise AssertionError("scale run disagrees with the CPU run")

    # the torch engine against the numpy f64 engine on a site window of
    # the same tree (per-site independence makes the window exact)
    import copy
    t = time.time()
    lo = (SCALE_COLS - EVAL_WINDOW) // 2
    ref = copy.copy(sdb.ptu)
    ref.evaluate(sites=(lo, lo + EVAL_WINDOW))
    numpy_s = time.time() - t
    ok, stats, msgs = evaluate_check(
        sdb.ptu, (ref.msg_up, ref.msg_down,
                  ref.tree_loglik(lo, lo + EVAL_WINDOW - 1)),
        rtol=EVAL_LL_RTOL, sites=(lo, lo + EVAL_WINDOW))
    del ref
    stats["numpy_window_s"] = numpy_s
    stats["build_sweeps_s"] = sweeps
    stats["bit_equal_to_build"] = all(
        np.array_equal(a, b) for a, b in zip(msgs, (sdb.ptu.msg_up,
                                                    sdb.ptu.msg_down)))
    del msgs
    torch.cuda.empty_cache()
    log(f"[evaluate] synthetic tree ({n_nodes} nodes x {SCALE_COLS} columns, "
        f"K=4), torch engine on the card (every site) vs the numpy f64 "
        f"engine on columns [{lo}, {lo + EVAL_WINDOW}): {json.dumps(stats)}")
    if not ok or not stats["bit_equal_to_build"]:
        raise AssertionError("torch evaluate engine disagrees at scale, or "
                             "with its own sweep in the build")

    t = time.time()
    resident_phase(sdb, sgpu[0], sgpu[1])
    log(f"[resident] phase took {time.time() - t:.1f} s")
    log(f"[scale] phase took {time.time() - t_scale:.1f} s")

    phase_s["scale+resident"] = lap()

    # ---- 11. the parallel layer -----------------------------------------
    parallel_phase(fx, fx_reads, sdb, s_reads)

    phase_s["parallel"] = lap()

    # ---- 12. the normal entry points: build -> DB files -> assign --------
    t = time.time()
    cli_phase()
    log(f"[cli] phase took {time.time() - t:.1f} s")

    phase_s["cli"] = lap()

    # ---- 13. config #3's path: a GTR+dGamma4 DB through the CLIs --------
    t = time.time()
    gamma_phase()
    log(f"[gamma] phase took {time.time() - t:.1f} s")

    phase_s["gamma"] = lap()

    # ---- 14. paired-end assign on the 6,000-column DB files --------------
    t = time.time()
    pe_cli_phase()
    log(f"[pe] 6,000-column phase took {time.time() - t:.1f} s")

    phase_s["pe_cli"] = lap()

    # ---- 15. config #5's path: a second sample, sum, merge ----------------
    t = time.time()
    otu_phase()
    log(f"[otu] phase took {time.time() - t:.1f} s")

    phase_s["otu"] = lap()

    # ---- 16. configs #1-#2 against the independent f64 oracle -----------
    t = time.time()
    oracle_phase()
    log(f"[oracle] phase took {time.time() - t:.1f} s")

    phase_s["oracle"] = lap()

    # ---- 17. assign's flags and the substitution models -------------------
    t = time.time()
    flags_phase()
    log(f"[flags] phase took {time.time() - t:.1f} s")

    phase_s["flags"] = lap()

    # ---- result ----------------------------------------------------------
    # launches and path_total_ms are those of the path that runs the
    # kernel: the scale run for K1-K3, the second path's run for K4, K5
    launches.update(mode_launches)
    kernel_ms.update(mode_ms)
    kernels = []
    for name, (_, _, src, rep) in kernel_table().items():
        r = kres[name]
        b_ms, b_by = bound(r["bytes"], r["ops"])
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "path_total_ms": kernel_ms[name]})
        for key in ("old_bound_ms", "chain_ms"):
            if key in r:
                kernels[-1][key] = r[key]
        if "launch_ms" in r:
            kernels[-1]["launch_ms"] = r["launch_ms"]
    for k in kernels:
        if k["name"] == "viterbi_traced":
            k["path_launches"] = scale_k1
            k["scale_shapes"] = scale_k1_shapes
        if k["name"] == "sep_optimize":
            k["path_launches"] = scale_k3
    log(f"[times] phase seconds {json.dumps(phase_s)}")
    log(f"[done] {time.time() - t_all:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
