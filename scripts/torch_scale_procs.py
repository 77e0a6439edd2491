"""`assign --num-processes N` at size through the PyTorch port's CLIs:
N processes a run, on one card or one card each, against one process;
single-end reads, pairs, and single-end reads with chimera checking
(`assign -C`); and one process over every card with `assign --mesh` and
`--mesh-tree`.

Each process of `assign --coordinator H:P --num-processes N --process-id
I` loads the whole DB, takes a contiguous shard of the reads, keeps its
rows in memory and hands them to process 0 over gloo at the end, which
writes them in process order (cli/assign.py, parallel/distributed.py).
This harness runs that path as a user would, each process a CLI in a
process of its own (scripts/torch_scale_cli.py's child runner), and
holds the gathered rows against one process's.  Steps:

  1. inputs  the evolved tree of scripts/evolved_inputs.py (MSA fasta,
             Newick, taxonomy); --reads 250 bp single-end amplicon reads
             of one REGION_COLS-column region (2% substitutions), and
             --pairs pairs of 2 x 250 bp mates from leaf fragments of
             N(500, 30^2) columns in the same region
             (torch_scale_e2e.simulate_pairs), as two FASTA files;
             --chimera-reads reads of the same region, every tenth a
             planted chimera of two leaves (simulate_chimera_reads, the
             truth in each description); on a card the kernels are
             built here, before any CLI starts;
  2. build   the build CLI (-s GTR --msg-dtype f32 --eval-engine torch);
  3. CPU     the CPU references, both at once, done before any card
             run: the first CHIMERA_PARITY -C reads (chimera_cpu), and
             with --mesh-tree the first MESH_TREE_CPU single-end reads
             through `assign --mesh-tree` on as many CPU shards as there
             are cards (the CLI's make_mesh patched);
  4. runs    single-end reads at each N of --processes, then the pairs at
             each N of --pair-processes, then the -C reads at each N of
             --chimera-processes (CHIMERA_ARGV and --chimera-out; .p<i>
             at N > 1), N = 1 first: N assign children
             started at once, each `main(argv + --num-processes N
             --process-id i --coordinator 127.0.0.1:<free port>)` with -a
             (its --align-out file gets the suffix .p<i> at N > 1); with
             --card-per-process child i sees card i alone
             (CUDA_VISIBLE_DEVICES=i) and a -C child card 0, else they
             share the card.  With --mesh, one more single-end run: one
             process over every card (`assign --mesh`, a replica a
             card).  With --mesh-tree, one more single-end run on the
             first --mesh-tree-reads reads and one more paired run on the
             first MESH_TREE_PAIRS pairs: one process over every card,
             `assign --mesh-tree` (the tree's messages in node blocks, a
             block a card).  On the CPU a mesh is CPU_SHARDS CPU shards
             (run_mesh).  A child that exits non-zero while others run
             stops the run after GRACE_S seconds;
  5. gates   every child exits 0; process 0's gathered TSV has data rows
             byte-equal to the N = 1 run's; the --align-out files
             present; process 0 of each N = 1 run holds its first
             --parity placements against the exact host path
             (torch_scale_cli's parity; at N > 1 the rows are held
             byte-equal to those, and parity is 0).  -C runs instead:
             no DevicePlacer built (no upload_s), K1 launched and K2, K3
             never in every process, main plus chimera rows one a read,
             the .p<i> chimera files' rows in turn byte-equal to the N
             = 1 file's, and the first CHIMERA_PARITY reads run again
             through the CLI on the CPU (chimera_cpu) with rows
             byte-equal to the card's, but at most CHIMERA_ALN_TIES
             reads whose alignment differs (a D-chain tie), named.
             The mesh runs (run_mesh): the process sees every card,
             with a device peak and K2, K3 launched on each, and writes
             a row a single-end read; --mesh: rows byte-equal to the N =
             1 run's; --mesh-tree: each shard's message bytes recorded,
             and its first reads' rows held against the CPU shards' by
             the rules of tests/test_torch_parallel.py (rows_differ),
             but a row that differs in branch or taxon alone passes as
             an f64 near tie (f64_near_ties: both branches scored by
             the host f64 SEP path within TIE_ULPS f32 ulps of its best,
             on at most TIE_SHARE of the rows); each read that differs
             named, with both rows' placement columns and its f64
             scores.  Any failure: rc 1.  Nothing falls back to the CPU
             or to one process;
  6. guards  an N is skipped, with its numbers in `skipped`, when N x
             (the N = 1 run's peak RSS) + 5 GB exceeds `free -g`'s total
             or, with the card shared, N x (its device peak + 1 GB)
             exceeds 76 GB.

Per process: rc, exit code, wall; load_s (by file, the .ptu.npz by
member), upload_s, stream_s (stream_single, or batch_loop for pairs and
--mesh), gather_s (write_gathered: at N > 1 process 0 waits for the
others' rows, then writes the TSV), the stream's host stages
(torch_scale_cli.StreamStages) and hmm.viterbi.TIMING, peak RSS, device
peak, CPU seconds (user + system, over the process and over its
stream), torch's threads and the npz reader's, K1-K3 launches and
CUDA-event ms, and whether its standard error holds an abort
(`terminate called`, ...) or it exited non-zero after its rows were
written (abort_after_rows); s_per_read, and for -C the seconds a read
by stage (chimera_split).  Per N: reads_per_s_stream (reads over the
slowest process's stream_s + gather_s: at N = 1 the stream writes the
TSV itself, at N > 1 process 0 writes it in gather_s, so every N is
clocked over the same work), reads_per_s_wall (reads over the seconds
from the launch to the last process's return from the CLI; process 0's
parity after it is not counted), each one's efficiency rate(N) / (N x
rate(1)), rows_equal and the --align-out files.  Every assign child
runs with -a, HMMUFOTU_TIMING=1 and torch_scale_cli's stage wrappers.
A mesh run also reports load, upload, tree_shards and merge seconds,
each card's busy ms (CUDA events around each shard's
place_batch_device) against the placement's host seconds, K1-K3
launches a card and device peaks a card; a --mesh-tree run its rows
against the one-card N = 1 run's (one_card_share: the share on the same
branch, the loglik deficit of the others; the reference's tree-sharded
merge can pick another branch).  `processes_scanned` counts the processes whose
standard error the abort scan read, the CPU references' among them;
`aborts` lists each that aborted, with its standard error's tail.
After the -C runs: the detection of the planted chimeras by the parents'
p-distance (`chimera_detection`) and the CPU run (`chimera_cpu`).  One
JSON line, the last the script prints, with every number, the card line, nproc,
`free -g`'s total and the card count; --progress FILE gets the numbers
so far after each run.

One H100, 65,535 nodes (two processes that place on the card at 149,999
nodes do not fit it):
    python scripts/torch_scale_procs.py --leaves 32768 --length 6000 \\
        --reads 400000 --pairs 50000 --processes 1,2,3 \\
        --progress out/procs.json
Four H100s, the gg_97 shape, one process a card, --mesh and --mesh-tree:
    python scripts/torch_scale_procs.py --leaves 75000 --length 6000 \\
        --reads 400000 --pairs 50000 --processes 1,2,4 \\
        --pair-processes 1,2,4 --card-per-process --mesh --mesh-tree \\
        --progress out/procs4.json
    (--mesh-tree alone: --reads 20000 --pairs 0 --processes ''
    --mesh-tree --mesh-tree-reads 20000 --parity 0; with -C on the
    host's cores, every process on card 0, in the same run:
    --chimera-reads 512 --chimera-processes 1,4,8)
One H100, the gg_97 shape, assign -C in one process and in two sharing
the card (--reads 0: no single-end runs):
    python scripts/torch_scale_procs.py --leaves 75000 --length 6000 \\
        --reads 0 --pair-processes '' --chimera-reads 256 \\
        --chimera-processes 1,2 --progress out/chim.json
CPU smoke:
    python scripts/torch_scale_procs.py --leaves 64 --length 600 \\
        --reads 256 --pairs 64 --processes 1,2 --eval-engine numpy \\
        --device cpu --work /tmp/procs
    (-C: --reads 0 --pair-processes '' --chimera-reads 40; the mesh runs:
    --reads 32 --pairs 8 --processes 1 --pair-processes 1 --mesh
    --mesh-tree)

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, SCRIPTS)

from evolved_inputs import (READ_LEN, input_tree,  # noqa: E402
                            simulate_reads, synth_inputs, write_fasta)
from torch_scale_assign import site_window  # noqa: E402
from torch_scale_cli import (build_db, finish_child,  # noqa: E402
                             free_total_gb, log, start_child, stream_rates)
from torch_scale_e2e import simulate_pairs  # noqa: E402
from torch_scale_eval import card_line  # noqa: E402

GG97_NODES = 149999
CONFIG5_READS = "100M+ reads"     # BASELINE config #5's reads
READS_SEED = 8                    # torch_scale_cli's reads' rng
PAIRS_SEED = 9
REGION_COLS = 1024                # torch_scale_cli's amplicon region
FRAGMENT = (500, 30)              # the sim CLI's fragment columns, N(m, sd^2)
RSS_MARGIN_GB = 5                 # host memory kept free beside N processes
DEVICE_MARGIN_GB = 1              # a process's context and allocator slack
CARD_BUDGET_GB = 76               # of the 80 GB card, for N shared processes
PARITY_GATE = 0.95
GRACE_S = 120.0                   # a failed child's siblings' time to end
# assign -C runs: every CHIMERA_EVERY-th read a planted chimera whose
# 5' part is CHIMERA_BREAK of the read; -s 1 skips the strand test (a
# shard's strand cannot differ), -b 64 gives the rate several batches
CHIMERA_READS = 1024              # -C reads of the at-size run; fewer is a cut
CHIMERA_SEED = 10
CHIMERA_EVERY = 10
CHIMERA_BREAK = (0.3, 0.7)
CHIMERA_ARGV = ["-C", "-s", "1", "-b", "64"]
PDIST_BINS = (0.03, 0.10)         # parents' p-distance: < 3%, 3-10%, >= 10%
BIN_NAMES = ("pdist<3%", "pdist3-10%", "pdist>=10%")
CHIMERA_PARITY = 32               # first -C reads run again on the CPU
CHIMERA_ALN_TIES = 1              # alignments a D-chain tie may change, of
#                                   the CHIMERA_PARITY reads
# assign --mesh-tree runs: one process over every card on the first
# MESH_TREE_READS single-end reads (the default of --mesh-tree-reads) and
# the first MESH_TREE_PAIRS pairs of --pairs; its first MESH_TREE_CPU reads run
# again on as many CPU shards as there are cards (CPU_SHARDS with
# --device cpu), rows held by the rules of tests/test_torch_parallel.py
MESH_TREE_READS = 100000
MESH_TREE_PAIRS = 10000
MESH_TREE_CPU = 32
CPU_SHARDS = 4
LL_RTOL, LL_ATOL = 1e-4, 0.5      # logliks of two placers
UNPLACED = "NULL"                 # the branch_id of an unplaced read's row
# a row of the CPU shards whose branch or taxon alone differs passes as
# an f32 near tie when both branches' f64 scores lie within TIE_ULPS f32
# ulps of the f64 best (scripts/torch_scale_e2e.py agreement's rule), on
# at most TIE_SHARE of the rows (chip_smoke.py compare_runs' limit for
# synthetic-DB reads)
TIE_ULPS = 8
TIE_SHARE = 0.25
# standard-error marks of a process that aborted
ABORT_MARKS = ("terminate called", "Aborted", "core dumped",
               "Segmentation fault", "Fatal Python error")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def nproc() -> int:
    return len(os.sched_getaffinity(0))


def card_count(dev) -> int:
    import torch
    return torch.cuda.device_count() if dev.type == "cuda" else 0


def child_env(i: int, card_per_process: bool,
              chimera: bool = False) -> dict | None:
    """Child i's additions to the environment of an N-process run: with
    --card-per-process it sees card i alone, a -C child card 0 (-C runs
    share it).  A mesh run's one process (run_mesh) sees every card."""
    if card_per_process:
        return {"CUDA_VISIBLE_DEVICES": "0" if chimera else str(i)}
    return None


# ---------------------------------------------------------------------------
# the arithmetic of a run, on the children's JSON lines
# ---------------------------------------------------------------------------

def abort_scan(err: str, rc, exit_code) -> dict:
    """A child's standard error and exit: the lines that mark an abort,
    and whether it exited non-zero after its CLI returned 0, that is,
    after its rows were written (gathered, at N > 1)."""
    lines = [ln.strip() for ln in err.splitlines()
             if any(m in ln for m in ABORT_MARKS)]
    return {"abort_lines": lines[:10],
            "aborted": bool(lines) or (exit_code is not None
                                       and exit_code < 0),
            "abort_after_rows": rc == 0 and exit_code != 0}


def skip_reason(n: int, rss1_gb: float, dev1_gb: float | None,
                free_gb: float | None, shared_card: bool) -> dict | None:
    """Why N processes would not fit, from the N = 1 run's peaks: None
    when they fit.  The host: N x rss1 + RSS_MARGIN_GB against `free
    -g`'s total; a shared card also N x (dev1 + DEVICE_MARGIN_GB)
    against CARD_BUDGET_GB."""
    why = {}
    need = n * rss1_gb + RSS_MARGIN_GB
    if free_gb is not None and need > free_gb:
        why["host"] = {"need_gb": need, "free_total_gb": free_gb,
                       "rss_one_gb": rss1_gb}
    if shared_card and dev1_gb is not None:
        need = n * (dev1_gb + DEVICE_MARGIN_GB)
        if need > CARD_BUDGET_GB:
            why["card"] = {"need_gb": need, "budget_gb": CARD_BUDGET_GB,
                           "device_peak_one_gb": dev1_gb}
    return {"processes": n, **why} if why else None


def rates(n: int, reads: int, procs: list[dict], launched_at: float,
          base: dict | None) -> dict:
    """An N-process run's rates: reads over the slowest process's stream
    and gather (at N = 1 the stream writes the TSV, at N > 1 process 0's
    gather does: the same work at every N) and over the seconds from the
    launch to the last process's return from the CLI; each one's
    efficiency against N x the N = 1 run's (base: that run's rates; None
    for the N = 1 run itself).  stream_s: the slowest stream alone."""
    clocks = [p["clocks"] for p in procs]
    stream = max(c["stream_s"] for c in clocks)
    rows = max(c["stream_s"] + c.get("gather_s", 0.0) for c in clocks)
    wall = max(p["main_returned_at"] for p in procs) - launched_at
    out = {"processes": n, "reads": reads, "stream_s": stream,
           "stream_gather_s": rows, "wall_s": wall,
           "reads_per_s_stream": reads / rows,
           "reads_per_s_wall": reads / wall}
    for k in ("stream", "wall"):
        one = (base or out)[f"reads_per_s_{k}"]
        out[f"efficiency_{k}"] = out[f"reads_per_s_{k}"] / (n * one)
    return out


def data_rows(path: str):
    """The data rows of an assignment TSV, as text, one at a time."""
    with open(path) as fh:
        for line in fh:
            if not line.startswith("#") and not line.startswith("id\t"):
                yield line


def rows_compare(paths: list[str], ref: str) -> dict:
    """Data rows of the files `paths`, read one after another, against
    those of the TSV `ref`, byte for byte, in order."""
    n = n_ref = differ = 0
    a = (row for p in paths for row in data_rows(p))
    b = data_rows(ref)
    while True:
        x, y = next(a, None), next(b, None)
        if x is None and y is None:
            break
        n += x is not None
        n_ref += y is not None
        differ += x != y
    return {"rows": n, "rows_ref": n_ref, "rows_differ": differ,
            "rows_equal": differ == 0 and n > 0}


def parity_ok(p: dict) -> bool:
    P = p.get("parity_reads", 0)
    return P > 0 and min(p["parity_cnode_match"],
                         p["parity_loglik_match"]) >= PARITY_GATE * P \
        and p["parity_tsv_rows_equal"] in (None, p["parity_rows"])


def launch_fails(tag: str, p: dict, chimera: bool) -> str | None:
    """A process's kernel launches against its run's: every main-path
    kernel (K1-K3) at least once, or under -C K1 at least once and the
    placement kernels K2, K3 never (-C places on the host)."""
    got = p["launches"]
    ok = (got["viterbi_traced"] > 0 and got["est"] == 0
          and got["sep_optimize"] == 0) if chimera \
        else min(got.values()) > 0
    return None if ok else f"{tag} process {p['process_id']} launches {got}"


# ---------------------------------------------------------------------------
# assign -C: planted chimeras, detection, the CPU's rows
# ---------------------------------------------------------------------------

def chimera_split(stages: dict, reads: int) -> dict:
    """A -C process's stream seconds a read by stage, from its
    StreamStages clocks: the alignment (align), the seed search over
    every node (get_seed), the chimera check's segment placements
    (segments) and the rest of it (alternatives: the two alternative
    placements and the segments' seed p-distances), the whole read's
    placement after it (host_sep) and the rest (rows)."""
    seg = stages.get("chimera_segments_s", 0.0)
    secs = {"align": stages.get("align_s", 0.0),
            "get_seed": stages.get("get_seed_s", 0.0), "segments": seg,
            "alternatives": stages.get("chimera_s", 0.0) - seg,
            "host_sep": stages.get("host_sep_s", 0.0),
            "rows": stages.get("rows_s", 0.0)}
    return {k: v / reads for k, v in secs.items()}


def simulate_chimera_reads(tree, rng, n: int, region, length=READ_LEN):
    """n single-end reads of `length` bp from MSA columns [lo, hi) of
    region, with 2% substitutions, as evolved_inputs.simulate_reads
    makes them; every CHIMERA_EVERY-th read (r9, r19, ...) a chimera of
    two distinct leaves, contiguous in columns: k residues of leaf a (k
    uniform in CHIMERA_BREAK of the read) up to a's break column, then
    residues of leaf b from the next column on.  The j-th chimera's b is
    drawn among the leaves whose p-distance to a over a's window falls
    in bin j % 3 (PDIST_BINS; the nearest leaf to that bin where none
    does), so that close and distant parents both occur.  Returns [(id,
    description, sequence)]; the description holds the truth:
    `chimera=0 parents=<a>`, or `chimera=1 parents=<a>,<b> break=<col>
    pdist=<p>` with the parents' p-distance over the read's columns."""
    lo, hi = region
    seqs, names = tree.seqs, tree.names
    leaves = np.asarray([u for u in range(tree.num_nodes)
                         if tree.is_leaf(u) and tree.msa_id[u] >= 0])
    k_lo = int(np.ceil(CHIMERA_BREAK[0] * length))
    k_hi = int(np.floor(CHIMERA_BREAK[1] * length))
    reads, n_chim = [], 0
    while len(reads) < n:
        a = int(rng.choice(leaves))
        pos = np.nonzero(seqs[a] >= 0)[0]
        pos = pos[(pos >= lo) & (pos < hi)]
        if len(pos) < length + 10:
            continue
        st = int(rng.integers(0, len(pos) - length - 5))
        if (len(reads) + 1) % CHIMERA_EVERY:
            piece = seqs[a][pos[st:st + length]].copy()
            desc = f"chimera=0 parents={names[a]}"
        else:
            k = int(rng.integers(k_lo, k_hi + 1))
            brk = int(pos[st + k - 1])
            d = p_dists(seqs, leaves, a, pos[st], pos[st + length - 1])
            near = (leaves != a) & np.isfinite(d)
            bin_ = n_chim % len(BIN_NAMES)
            pick = near & (np.digitize(d, PDIST_BINS) == bin_)
            if pick.any():
                b = int(rng.choice(leaves[pick]))
            else:
                centre = (0.0, sum(PDIST_BINS) / 2, 1.0)[bin_]
                b = int(leaves[near][np.argmin(abs(d[near] - centre))])
            pos_b = np.nonzero(seqs[b] >= 0)[0]
            pos_b = pos_b[(pos_b > brk) & (pos_b < hi)][:length - k]
            if len(pos_b) < length - k:
                continue
            piece = np.concatenate([seqs[a][pos[st:st + k]],
                                    seqs[b][pos_b]])
            pd = p_dists(seqs, np.asarray([b]), a, pos[st], pos_b[-1])[0]
            desc = (f"chimera=1 parents={names[a]},{names[b]} break={brk} "
                    f"pdist={pd:.6f}")
            n_chim += 1
        mut = rng.random(len(piece)) < 0.02
        piece[mut] = rng.integers(0, 4, int(mut.sum()))
        reads.append((f"r{len(reads)}", desc,
                      "".join("ACGT"[c] for c in piece)))
    return reads


def p_dists(seqs, rows, a: int, c0: int, c1: int) -> np.ndarray:
    """p-distance of leaf a to each of `rows` over columns [c0, c1],
    where both have a residue (nan where they share none)."""
    w = seqs[rows, c0:c1 + 1]
    q = seqs[a, c0:c1 + 1][None, :]
    both = (w >= 0) & (q >= 0)
    n = both.sum(1)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(n > 0, ((w != q) & both).sum(1) / n, np.nan)


def write_reads(path: str, reads) -> str:
    with open(path, "w") as fh:
        fh.write("".join(f">{rid} {desc}\n{seq}\n"
                         for rid, desc, seq in reads))
    return path


def chimera_rows(tsv: str, chi: str) -> dict:
    """The rows of an assign -C run by read id: (flagged, row), flagged
    when the row is in the --chimera-out file."""
    return {row.split("\t", 1)[0]: (flagged, row)
            for path, flagged in ((tsv, False), (chi, True))
            for row in data_rows(path)}


def detection(tsv: str, chi: str) -> dict:
    """Planted chimeras flagged (their rows in the --chimera-out file) by
    the parents' p-distance bin, all of them, and clean reads flagged;
    each group's reads, flagged count and share, and the quantiles (0,
    25, 50, 75, 100%) of its finite chimera lods (column 15).  The truth
    is each read's description (simulate_chimera_reads); a clean read
    has one parent, so it has no bin."""
    groups = {g: [] for g in BIN_NAMES + ("planted", "clean")}
    for flagged, row in chimera_rows(tsv, chi).values():
        f = row.rstrip("\n").split("\t")
        truth = dict(kv.split("=", 1) for kv in f[1].split())
        entry = (flagged, float(f[14]))
        if truth["chimera"] == "1":
            groups["planted"].append(entry)
            bin_ = int(np.digitize(float(truth["pdist"]), PDIST_BINS))
            groups[BIN_NAMES[bin_]].append(entry)
        else:
            groups["clean"].append(entry)
    out = {}
    for g, entries in groups.items():
        lods = np.asarray([x for _, x in entries if np.isfinite(x)])
        k = sum(f for f, _ in entries)
        out[g] = {"reads": len(entries), "flagged": k,
                  "share": k / len(entries) if entries else None,
                  "lod_quantiles": np.quantile(
                      lods, [0, 0.25, 0.5, 0.75, 1]).tolist()
                  if len(lods) else None,
                  "lod_not_finite": len(entries) - len(lods)}
    return out


def cpu_rows_compare(cpu: dict, card: dict, n: int) -> dict:
    """A CPU run's -C rows (chimera_rows) against the card's for the
    same reads: each read flagged alike and its row byte-equal, except a
    read whose alignment (columns 3-10) differs, as a D-chain tie may
    make it (parity rule 2): those are named, and at most
    CHIMERA_ALN_TIES may occur.  n: the reads the CPU run was given."""
    missing = [i for i in cpu if i not in card]
    aln, other = [], []
    for i, (flagged, row) in cpu.items():
        if i in missing or card[i] == (flagged, row):
            continue
        if row.split("\t")[2:10] != card[i][1].split("\t")[2:10]:
            aln.append(i)
        else:
            other.append(i)
    return {"reads": len(cpu), "rows_equal": len(cpu) - len(aln)
            - len(other) - len(missing), "alignment_differs": aln,
            "rows_differ": other, "missing_on_card": missing,
            "ok": len(cpu) == n and not missing and not other
            and len(aln) <= CHIMERA_ALN_TIES}


# ---------------------------------------------------------------------------
# one run: N children at once
# ---------------------------------------------------------------------------

def finish_all(children, grace: float) -> list[dict]:
    """finish_child of every child, each on a thread of its own (so no
    child blocks on a full pipe); once one has exited non-zero, the
    others get `grace` seconds (a process left alone in a collective
    waits for gloo's 30-minute timeout), then are killed."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(children)) as ex:
        futs = [ex.submit(finish_child, c) for c in children]
        failed_at = None
        while not all(f.done() for f in futs):
            if failed_at is None and any(p.poll() not in (None, 0)
                                         for p, _ in children):
                failed_at = time.perf_counter()
            if failed_at is not None \
                    and time.perf_counter() - failed_at > grace:
                for p, _ in children:
                    if p.poll() is None:
                        log(f"killing child {p.pid}: another one failed")
                        p.kill()
            time.sleep(0.5)
        return [f.result() for f in futs]


def run_children(args, tag: str, n: int, argv: list[str], tsv: str,
                 parity: int, env_of, chimera: bool = False,
                 cpu_shards: int = 0) -> tuple[list[dict], float]:
    """N assign children of `argv` at once, child i with `--num-processes
    N --process-id i --coordinator 127.0.0.1:<free port>`, env_of(i)'s
    environment, its standard error in <tag>.p<i>.stderr, and parity
    (process 0 only) and cpu_shards for start_child; on a card K1-K3
    counted.  Returns (each process's numbers, the launch time)."""
    d = args.work
    port = free_port()
    cuda = args.device != "cpu"
    children, errs, envs = [], [], []
    launched_at = time.time()
    for i in range(n):
        env = env_of(i)
        envs.append(env)
        errs.append(os.path.join(d, f"{tag}.p{i}.stderr"))
        with open(errs[-1], "w") as err:
            children.append(start_child(
                "assign", argv + ["--num-processes", str(n),
                                  "--process-id", str(i), "--coordinator",
                                  f"127.0.0.1:{port}"],
                args, tsv, parity=parity if i == 0 else 0, kernels=cuda,
                env=env, stderr=err, cpu_shards=cpu_shards))
    procs = []
    for i, (p, err) in enumerate(zip(finish_all(children, GRACE_S),
                                     errs)):
        stamps = p.pop("stamps", [])
        p["processed"] = [[t, int(m.split()[1])] for t, m in stamps
                          if m.startswith("Processed ")]
        stream_s = p.get("clocks", {}).get("stream_s")
        if stream_s:
            p["rates"] = stream_rates(p["processed"], stream_s)
        with open(err) as fh:
            text = fh.read()
        p.update(abort_scan(text, p["rc"], p["exit"]))
        if p["exit"] != 0:
            p["stderr_tail"] = text[-3000:]
        p["process_id"] = i
        p["cuda_visible_devices"] = (envs[i] or {}).get(
            "CUDA_VISIBLE_DEVICES")
        if stream_s and p["processed"]:
            p["s_per_read"] = stream_s / p["processed"][-1][1]
            if chimera:
                p["chimera_split_s_per_read"] = chimera_split(
                    p["stream_stages_s"], p["processed"][-1][1])
        procs.append(p)
    return procs, launched_at


def proc_fails(tag: str, procs: list[dict], cuda: bool,
               chimera: bool) -> list[str]:
    """Every process exits 0 after its CLI returned 0; on a card its
    kernel launches (launch_fails); under -C no DevicePlacer built."""
    fails = []
    for p in procs:
        if p["rc"] != 0 or p["exit"] != 0:
            fails.append(f"{tag} process {p['process_id']} rc {p['rc']} "
                         f"exit {p['exit']}")
        why = launch_fails(tag, p, chimera) if cuda and p["rc"] == 0 \
            else None
        if why:
            fails.append(why)
        if chimera and "upload_s" in p.get("clocks", {}):
            fails.append(f"{tag} process {p['process_id']} built a "
                         "DevicePlacer under -C")
    return fails


def align_out_check(out: dict, aln: str, n: int) -> None:
    """The --align-out files of an N-process run (aln, or aln.p<i> at N >
    1): present, their bytes in out, then removed; a fail where one is
    missing or, at N > 1, aln itself exists."""
    names = [aln] if n == 1 else [f"{aln}.p{i}" for i in range(n)]
    out["align_out"] = {os.path.basename(f): os.path.exists(f)
                        for f in names}
    out["align_out_bytes"] = sum(os.path.getsize(f) for f in names
                                 if os.path.exists(f))
    for f in names:
        if os.path.exists(f):
            os.remove(f)
    if not all(out["align_out"].values()) or os.path.exists(aln) and n > 1:
        out["fails"].append(f"{out['run']} --align-out files "
                            f"{out['align_out']}")


def run_n(args, tag: str, n: int, inputs: list[str], prefix: str,
          base: dict | None, reads: int, chimera: bool = False) -> dict:
    """N assign children at once on `inputs` (`reads` reads or pairs);
    the run's per-process and per-N numbers and its gates (against base,
    the N = 1 run).  chimera: with CHIMERA_ARGV and --chimera-out, no
    host parity, and the -C gates (no placer built, no placement kernel
    launched, the .p<i> chimera files against base's)."""
    d = args.work
    tsv = os.path.join(d, f"{tag}.tsv")
    aln = os.path.join(d, f"{tag}.aln.fa")
    chi = os.path.join(d, f"{tag}.chi.tsv")
    argv = [prefix, *inputs, "-o", tsv, "-a", aln]
    if chimera:
        argv += CHIMERA_ARGV + ["--chimera-out", chi]
    cuda = args.device != "cpu"
    procs, launched_at = run_children(
        args, tag, n, argv, tsv,
        args.parity if base is None and not chimera else 0,
        lambda i: child_env(i, args.card_per_process and cuda, chimera),
        chimera)
    out = {"run": tag, "procs": procs,
           "fails": proc_fails(tag, procs, cuda, chimera)}
    fails = out["fails"]
    if fails:
        return out
    out.update(rates(n, reads, procs, launched_at, base))
    out["last_exit_s"] = max(p["wall_s"] for p in procs)
    out["cpu_s"] = sum(p["cpu_s"] for p in procs)
    align_out_check(out, aln, n)
    if base is None:
        out["tsv"] = tsv
        out["rows"] = sum(1 for _ in data_rows(tsv))
        if chimera:
            out["chi_tsv"] = chi
            out["chimera_rows"] = sum(1 for _ in data_rows(chi))
            if out["rows"] + out["chimera_rows"] != reads:
                fails.append(f"{tag} rows {out['rows']} + chimera rows "
                             f"{out['chimera_rows']} != {reads} reads")
        elif args.parity and not parity_ok(procs[0]):
            fails.append(f"{tag} parity")
    else:
        out.update(rows_compare([tsv], base["tsv"]))
        if not out["rows_equal"] or out["rows"] != out["rows_ref"]:
            fails.append(f"{tag} rows differ from one process: "
                         f"{out['rows_differ']} of {out['rows_ref']}")
        if chimera:
            # --chimera-out is not gathered: each process writes .p<i>
            parts = [f"{chi}.p{i}" for i in range(n)]
            have = all(map(os.path.exists, parts))
            got = rows_compare(parts, base["chi_tsv"]) if have else {}
            out["chimera_out"] = dict(got, files=[os.path.basename(f)
                                                  for f in parts],
                                      present=have)
            if not have or os.path.exists(chi) or got["rows_differ"] \
                    or got["rows"] != got["rows_ref"]:
                fails.append(f"{tag} --chimera-out .p<i> files against "
                             f"one process's: {out['chimera_out']}")
    return out


def brief(r: dict) -> dict:
    """A run without its per-process detail, for the log."""
    keep = {k: v for k, v in r.items() if k != "procs"}
    keep["procs"] = [{k: p.get(k) for k in (
        "rc", "exit", "wall_s", "cpu_s", "stream_cpu_s", "peak_rss_gb",
        "device_peak_gb", "cards_seen", "clocks", "stream_stages_s",
        "s_per_read", "chimera_split_s_per_read", "launches",
        "kernel_ms", "launches_by_card", "device_peaks_gb",
        "card_busy_ms", "aborted", "abort_after_rows")}
        for p in r["procs"]]
    return keep


# ---------------------------------------------------------------------------
# CPU references: -C's and --mesh-tree's first reads through the CLI on
# the CPU, started together after the build and done before any card run
# ---------------------------------------------------------------------------

def start_cpu_ref(args, prefix: str, tag: str, fasta: str, extra,
                  cpu_shards: int = 0):
    """The port's assign CLI on the CPU on `fasta`, in a process of its
    own, with the flags `extra` (and `cpu_shards` CPU shards for a mesh
    flag), its standard error in <tag>.stderr.  Returns what
    finish_cpu_ref takes."""
    tsv = os.path.join(args.work, f"{tag}.tsv")
    err = os.path.join(args.work, f"{tag}.stderr")
    with open(err, "w") as fh:
        started = start_child("assign", [prefix, fasta, "-o", tsv, *extra],
                              args, parity=0, device="cpu", stderr=fh,
                              cpu_shards=cpu_shards)
    return started, tsv, err


def finish_cpu_ref(started, tsv: str, err: str) -> dict:
    """A CPU reference's numbers and its TSV, and the abort scan of its
    standard error (its tail where it exited non-zero)."""
    got = finish_child(started)
    out = dict({k: got.get(k) for k in ("rc", "exit", "wall_s", "clocks",
                                        "peak_rss_gb", "stream_stages_s")},
               tsv=tsv, process_id=0)
    with open(err) as fh:
        text = fh.read()
    out.update(abort_scan(text, out["rc"], out["exit"]))
    if out["exit"] != 0:
        out["stderr_tail"] = text[-3000:]
    return out


def chimera_cpu(ref: dict, n: int, base: dict) -> dict:
    """The CPU run of the first n -C reads (CHIMERA_ARGV, the card runs'
    flags) against the card's N = 1 rows (cpu_rows_compare)."""
    out = {k: v for k, v in ref.items() if k != "tsv"}
    if ref["rc"] != 0:
        return dict(out, ok=False)
    card = chimera_rows(base["tsv"], base["chi_tsv"])
    tsv = ref["tsv"]
    cpu = chimera_rows(tsv, tsv[:-len(".tsv")] + ".chi.tsv")
    return dict(out, **cpu_rows_compare(cpu, card, n))


# ---------------------------------------------------------------------------
# assign --mesh-tree: one process over every card, the tree's messages in
# node blocks
# ---------------------------------------------------------------------------

def split_rows(path: str) -> list[list[str]]:
    """The data rows of an assignment TSV, split into fields."""
    return [row.rstrip("\n").split("\t") for row in data_rows(path)]


def rows_differ(got: list, want: list) -> list[str]:
    """Rows of two assignment TSVs (split_rows) by the rules of
    tests/test_torch_parallel.py rows_agree: the same ids in order, the
    same alignment columns, branch and taxon, logliks within LL_RTOL
    relative or LL_ATOL; an unplaced read unplaced in both.  Returns
    each row that breaks them: its id and what differs."""
    out = []
    for k in range(max(len(got), len(want))):
        if k >= min(len(got), len(want)) or got[k][0] != want[k][0]:
            ids = [r[k][0] if k < len(r) else None for r in (got, want)]
            out.append(f"row {k}: ids {ids}")
            continue
        g, w = got[k], want[k]
        what = ["alignment"] if g[2:10] != w[2:10] else []
        if UNPLACED in (g[10], w[10]):
            if g[10:] != w[10:]:
                what.append("placement")
        else:
            if (g[10], g[12], g[13]) != (w[10], w[12], w[13]):
                what.append("branch or taxon")
            lg, lw = float(g[15]), float(w[15])
            if not abs(lg - lw) <= max(LL_RTOL * abs(lw), LL_ATOL):
                what.append("loglik")
        if what:
            out.append(f"{g[0]}: {', '.join(what)}")
    return out


def near_tie(best: float, card: float, cpu: float) -> dict:
    """Two branches' f64 logliks against the f64 best `best`: each one's
    gap (best less it) in f32 ulps of |best|, and whether both lie within
    TIE_ULPS of it, either way (scripts/torch_scale_e2e.py agreement)."""
    ulp = abs(best) * 2.0 ** -23
    gaps = {k: (best - x) / ulp for k, x in (("card", card), ("cpu", cpu))}
    tie = all(abs(x) <= TIE_ULPS for x in gaps.values())
    return {"ulp": ulp, "card_gap_ulps": gaps["card"],
            "cpu_gap_ulps": gaps["cpu"],
            "verdict": "near tie" if tie else "not a near tie"}


def aligned_read(row: list):
    """A row's aligned read as the host placer takes it: its alignment
    column (the string the -a FASTA holds) encoded, and its 0-based
    CS_start and CS_end."""
    from hmmufotu_tpu_torch.alphabet import DNA
    return DNA.encode_upper(row[9]), int(row[6]) - 1, int(row[7]) - 1


class F64Scores:
    """The f64 host SEP path (pipeline.assign_read's steps) on the DB
    files at `prefix`, the tree loaded on the host on the first call (no
    upload, nothing of the placer).  Called with a pair of rows of one
    read, it places the read (its alignment column, the string the -a
    FASTA holds, from CS_start to CS_end) as assign_read does: get_seed,
    estimate_seq, filter_placements, place_seq, and gives the best f64
    loglik L* of those candidates; then it scores each row's branch c->p
    alone: tree.estimate_seq at PTLoc(start, end, c, the p-distance
    get_seed gives c), then tree.place_seq.  Logliks at full precision
    (PTPlacement.loglik), never the TSV's printed ones."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self.tree = None
        self.load_s = None
        self.score_s = 0.0

    def best(self, seq, start: int, end: int):
        """The f64 host path's candidates' best placement (its L*)."""
        from hmmufotu_tpu_torch import pipeline as pl
        places = pl.estimate_seq(self.tree, seq,
                                 pl.get_seed(self.tree, seq, start, end))
        places = pl.place_seq(self.tree, seq, pl.filter_placements(places))
        return max(places, key=lambda p: p.loglik)

    def branch(self, seq, start: int, end: int, branch: str) -> float:
        """The f64 loglik of the read placed on `branch` (c->p) alone."""
        from hmmufotu_tpu_torch.phylo.tree import PTLoc, p_dist
        c, p = map(int, branch.split("->"))
        if int(self.tree.parent[c]) != p:
            return float("nan")         # not a branch: never a near tie
        loc = PTLoc(start, end, c, p_dist(self.tree.seqs[c], seq, start,
                                          end))
        return self.tree.place_seq(
            seq, self.tree.estimate_seq(seq, loc)).loglik

    def __call__(self, card: list, cpu: list) -> dict:
        if self.tree is None:
            from hmmufotu_tpu_torch.phylo.tree import PTUnrooted
            t = time.perf_counter()
            self.tree = PTUnrooted.load(self.prefix + ".ptu.npz")
            self.load_s = time.perf_counter() - t
        t = time.perf_counter()
        seq, start, end = aligned_read(card)
        best = self.best(seq, start, end)
        out = {"best_branch": best.get_id(), "best_loglik": best.loglik,
               "card_branch": card[10], "cpu_branch": cpu[10],
               "card_loglik": self.branch(seq, start, end, card[10]),
               "cpu_loglik": self.branch(seq, start, end, cpu[10])}
        self.score_s += time.perf_counter() - t
        return out


def f64_near_ties(card: list, cpu: list, score) -> dict:
    """The card run's rows against the CPU shards' (split_rows, the same
    reads) by rows_differ, but a row whose only difference is its branch
    or taxon is judged by its f64 scores, score(card row, CPU row) ->
    {best_loglik, card_loglik, cpu_loglik, ...} (F64Scores): it passes
    as an f32 near tie when both branches lie within TIE_ULPS f32 ulps
    of the f64 best (near_tie).  ok: some rows, every other rule held,
    every such row a near tie, and no more of them than TIE_SHARE of the
    rows.  Each row that differs is in differ_rows with both rows'
    placement columns (branch_id ... Q_taxon) and, when scored, its f64
    scores, ulp gaps and verdict; each failure is named in fails."""
    differ = rows_differ(card, cpu)
    what = dict(d.split(": ", 1) for d in differ)
    fails = [d for d in differ if not d.endswith(": branch or taxon")]
    rows, ties = [], []
    for g, w in zip(card, cpu):
        if g[0] != w[0] or g[0] not in what:
            continue
        r = {"id": g[0], "card": g[10:], "cpu": w[10:]}
        rows.append(r)
        if what[g[0]] != "branch or taxon":
            continue
        f = r["f64"] = score(g, w)
        f.update(near_tie(f["best_loglik"], f["card_loglik"],
                          f["cpu_loglik"]))
        if f["verdict"] == "near tie":
            ties.append(g[0])
        else:
            fails.append(
                f"{g[0]}: branch or taxon, {f['verdict']}: f64 card "
                f"{f['card_branch']} {f['card_loglik']!r}, CPU "
                f"{f['cpu_branch']} {f['cpu_loglik']!r}, best "
                f"{f['best_branch']} {f['best_loglik']!r} "
                f"({f['card_gap_ulps']:.3f}, {f['cpu_gap_ulps']:.3f} ulps)")
    limit = TIE_SHARE * len(cpu)
    if len(ties) > limit:
        fails.append(f"{len(ties)} near ties in {len(cpu)} rows, over "
                     f"{TIE_SHARE:.0%} ({limit:g})")
    return {"reads": len(cpu), "agree": len(cpu) - len(differ),
            "differ": differ, "differ_rows": rows, "near_ties": ties,
            "near_tie_limit": limit, "fails": fails,
            "ok": bool(cpu) and not fails}


def mesh_tree_cpu(ref: dict, tsv: str, prefix: str) -> dict:
    """The CPU shards' run of the first reads against the card run's
    rows of the same reads (f64_near_ties): the rules of rows_differ,
    but a row that differs in branch or taxon alone passes when the
    port's f64 host SEP path, on the DB files at `prefix` (F64Scores,
    loaded here once, only when such a row exists), scores both
    branches within TIE_ULPS f32 ulps of its best, and no more than
    TIE_SHARE of the rows do so.  Before, any such row failed, and the
    TSV's logliks, within LL_RTOL of ~-8.7e6 at the gg_97 shape (~870
    nats), passed any flip; now a flip needs an f64 proof that both
    branches are within ~8 nats there of the f64 optimum."""
    out = {k: v for k, v in ref.items() if k != "tsv"}
    if ref["rc"] != 0:
        return dict(out, ok=False)
    cpu = split_rows(ref["tsv"])
    card = split_rows(tsv)[:len(cpu)]
    score = F64Scores(prefix)
    out.update(f64_near_ties(card, cpu, score))
    out["f64_load_s"], out["f64_score_s"] = score.load_s, score.score_s
    return out


def one_card_share(tsv: str, one_tsv: str) -> dict:
    """The --mesh-tree rows against the one-card N = 1 run's rows of the
    same reads (by id): the share of placed reads on the same branch,
    and the quantiles (0, 25, 50, 75, 100%) of the loglik deficit (one
    card's less the shards') of those on another.  Reported only: the
    tree-sharded merge of both packages filters each shard's candidates
    against its own block's best estimate and can pick another branch
    (tests/test_torch_mesh_tree.py)."""
    mt = {r[0]: r for r in split_rows(tsv)}
    seen = placed = same = unplaced_differ = 0
    deficit = []
    for r in data_rows(one_tsv):
        r = r.rstrip("\n").split("\t")
        g = mt.get(r[0])
        if g is None:
            continue
        seen += 1
        if UNPLACED in (g[10], r[10]):
            unplaced_differ += g[10] != r[10]
        else:
            placed += 1
            if g[10] == r[10]:
                same += 1
            else:
                deficit.append(float(r[15]) - float(g[15]))
        if seen == len(mt):
            break
    return {"rows": len(mt), "matched": seen, "placed": placed,
            "same_branch": same, "share": same / placed if placed
            else None, "other_branch": len(deficit),
            "unplaced_differ": unplaced_differ,
            "loglik_deficit_quantiles": np.quantile(
                deficit, [0, 0.25, 0.5, 0.75, 1]).tolist()
            if deficit else None,
            "deficit_below_zero": sum(x < 0 for x in deficit)}


def run_mesh(args, flag: str, mode: str, inputs: list[str], prefix: str,
             reads: int, shards: int, base: dict | None,
             cpu_ref: dict | None = None) -> dict:
    """One process over every card (on the CPU: `shards` CPU shards)
    with `assign <flag> -a` on `inputs` (`reads` reads or pairs), flag
    --mesh or --mesh-tree.  Gates (rc 1): it exits 0, sees `shards`
    cards with a device peak on each and K2 and K3 launched on each, and
    writes a row a single-end read; --mesh: its rows byte-equal to
    base's (the N = 1 run's); --mesh-tree: each shard's message bytes
    recorded, and (cpu_ref, the CPU shards' run of its first reads) its
    rows held against the CPU's by mesh_tree_cpu: as rows_differ, but a
    row that differs in branch or taxon alone passes if the f64 host
    path scores both branches within TIE_ULPS f32 ulps of its best, on
    at most TIE_SHARE of the rows (before, none could differ).
    Reported: reads/s (its efficiency: the ratio to base), load,
    upload, tree_shards and merge seconds, each card's busy ms against
    the placement's host seconds, K1-K3 a card, and under --mesh-tree
    the share of rows on base's branch (one_card_share) and the f64
    load and score seconds of the CPU check."""
    d = args.work
    tag = f"{mode}_{flag[2:].replace('-', '_')}"
    tsv = os.path.join(d, f"{tag}.tsv")
    aln = os.path.join(d, f"{tag}.aln.fa")
    cuda = args.device != "cpu"
    tree = flag == "--mesh-tree"
    argv = [prefix, *inputs, "-o", tsv, "-a", aln, flag]
    procs, launched_at = run_children(args, tag, 1, argv, tsv, 0,
                                      lambda i: None,
                                      cpu_shards=0 if cuda else shards)
    out = {"run": tag, "procs": procs,
           "fails": proc_fails(tag, procs, cuda, False)}
    fails, p = out["fails"], procs[0]
    if p["rc"] == 0:
        if tree:
            got = p.get("shards", [])
            out["shard_msg_bytes"] = [x["msg_bytes"] for x in got]
            if len(got) != shards or min(out["shard_msg_bytes"]) <= 0:
                fails.append(f"{tag} shards {got}: {shards} asked")
        if cuda:
            peaks = p.get("device_peaks_gb") or []
            if p["cards_seen"] != shards or len(peaks) != shards \
                    or not all(x and x > 0 for x in peaks):
                fails.append(f"{tag} saw {p['cards_seen']} of {shards} "
                             f"cards, device peaks {peaks}")
            by = p.get("launches_by_card", {})
            idle = {k: sorted(set(map(str, range(shards)))
                              - set(by.get(k, {})))
                    for k in ("est", "sep_optimize")}
            if any(idle.values()):
                fails.append(f"{tag} cards without a launch: {idle}")
    if fails:
        return out
    out.update(rates(1, reads, procs, launched_at, base))
    out["cpu_s"] = p["cpu_s"]
    align_out_check(out, aln, 1)
    out["tsv"] = tsv
    out["rows"] = sum(1 for _ in data_rows(tsv))
    if mode == "se" and out["rows"] != reads:
        fails.append(f"{tag} rows {out['rows']} of {reads} reads")
    c = p["clocks"]
    place_s = p["stream_stages_s"].get("place_s")
    busy = p.get("card_busy_ms") or {}
    out["placement"] = {
        "load_s": c.get("load_s"), "upload_s": c.get("upload_s"),
        "tree_shards_s": c.get("tree_shards_s"), "place_s": place_s,
        "merge_s": c.get("merge_s"), "card_busy_ms": busy,
        "busy_over_place": sum(busy.values()) / 1e3 / place_s
        if busy and place_s else None,
        "launches_by_card": p.get("launches_by_card"),
        "device_peaks_gb": p.get("device_peaks_gb"),
        "shards": p.get("shards")}
    if not tree:
        out.update(rows_compare([tsv], base["tsv"]))
        if not out["rows_equal"] or out["rows"] != out["rows_ref"]:
            fails.append(f"{tag} rows differ from one process: "
                         f"{out['rows_differ']} of {out['rows_ref']}")
        return out
    if base is not None:
        out["one_card"] = one_card_share(tsv, base["tsv"])
    if cpu_ref is not None:
        c = out["cpu"] = mesh_tree_cpu(cpu_ref, tsv, prefix)
        if not c["ok"]:
            fails.append(f"{tag} rows against the CPU shards': "
                         f"{c.get('fails')} (rc {c['rc']})")
    return out


# ---------------------------------------------------------------------------

def parse_counts(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x] if text else []


def write_pairs(d: str, name: str, fwd, rev) -> list[str]:
    paths = [os.path.join(d, f"{name}_{k}.fasta") for k in (1, 2)]
    for path, mates in zip(paths, (fwd, rev)):
        with open(path, "w") as fh:
            fh.write("".join(f">{r.id} {r.desc}\n{r.seq}\n" for r in mates))
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--leaves", type=int, default=32768)
    ap.add_argument("--length", type=int, default=6000)
    ap.add_argument("--reads", type=int, default=400000,
                    help="single-end amplicon reads of one region")
    ap.add_argument("--pairs", type=int, default=50000)
    ap.add_argument("--processes", default="1,2,3",
                    help="N of the single-end runs, 1 first")
    ap.add_argument("--pair-processes", default="1,2",
                    help="N of the paired runs, 1 first ('' for none)")
    ap.add_argument("--card-per-process", action="store_true",
                    help="child i sees card i alone "
                         "(CUDA_VISIBLE_DEVICES=i)")
    ap.add_argument("--mesh", action="store_true",
                    help="one more single-end run: one process, "
                         "assign --mesh over every card")
    ap.add_argument("--mesh-tree", action="store_true",
                    help="one more single-end run and one more paired "
                         "run: one process, assign --mesh-tree over "
                         "every card")
    ap.add_argument("--mesh-tree-reads", type=int, default=MESH_TREE_READS,
                    help="the first reads of the single-end file that "
                         "the --mesh-tree run assigns")
    ap.add_argument("--parity", type=int, default=128,
                    help="reads of process 0 of each N = 1 run held "
                         "against the host path")
    ap.add_argument("--chimera-reads", type=int, default=0,
                    help="assign -C reads (every tenth a planted "
                         f"chimera); 0: no -C runs, {CHIMERA_READS} "
                         "asked for at size")
    ap.add_argument("--chimera-processes", default="1,2",
                    help="N of the -C runs, 1 first")
    ap.add_argument("--eval-engine", default="torch",
                    choices=["torch", "numpy"])
    ap.add_argument("--work", default=os.path.join(
        REPO, ".bench", "torch_scale_procs"),
        help="directory of the inputs, DB files, TSVs and logs")
    ap.add_argument("--progress", default="",
                    help="JSON file holding the numbers so far")
    ap.add_argument("--why", default="",
                    help="why --leaves is below the gg_97 shape's")
    ap.add_argument("--device", default="cuda",
                    help="cuda; cpu only when asked for")
    args = ap.parse_args(argv)
    se_ns = parse_counts(args.processes) if args.reads else []
    pe_ns = parse_counts(args.pair_processes) if args.pairs else []
    ch_ns = parse_counts(args.chimera_processes) \
        if args.chimera_reads else []
    mt_reads = min(args.mesh_tree_reads, args.reads) \
        if args.mesh_tree else 0
    mt_pairs = min(MESH_TREE_PAIRS, args.pairs) if args.mesh_tree else 0
    if not se_ns + pe_ns + ch_ns and not mt_reads + mt_pairs:
        ap.error("no run: --reads 0 and no --pair-processes, "
                 "--chimera-reads or --mesh-tree")
    for ns in (se_ns, pe_ns, ch_ns):
        if ns and (ns[0] != 1 or sorted(set(ns)) != ns):
            ap.error("process counts rise from 1: " + ",".join(map(str, ns)))
    all_ns = se_ns + pe_ns + ch_ns

    from hmmufotu_tpu_torch._cuda import resolve_device
    dev = resolve_device(args.device)
    cards = card_count(dev)
    # -C runs share card 0: --card-per-process gives cards to the others
    if args.card_per_process and max(se_ns + pe_ns, default=0) > cards:
        ap.error(f"--card-per-process needs {max(se_ns + pe_ns)} cards; "
                 f"{cards} seen")
    shards = cards if dev.type == "cuda" else CPU_SHARDS
    n_nodes = 2 * args.leaves - 1
    cuts = ([("nodes", f"{GG97_NODES:,} nodes", f"{n_nodes:,} nodes")]
            if n_nodes < GG97_NODES else [])
    runs = [f"{k:,} {what}" for k, what, ns in (
        (args.reads, "reads", se_ns), (args.pairs, "pairs", pe_ns),
        (args.chimera_reads, "-C reads", ch_ns)) if ns]
    if ch_ns and args.chimera_reads < CHIMERA_READS:
        runs[-1] += f" (of {CHIMERA_READS} asked)"
    mt = [f"{k:,} {what}" for k, what in ((mt_reads, "reads"),
                                          (mt_pairs, "pairs")) if k]
    if mt:
        runs.append("the first " + " and ".join(mt) + " under --mesh-tree")
    cuts += [("reads", CONFIG5_READS, ", ".join(runs)),
             ("hosts", "N hosts (BASELINE configs #4-#5)",
              f"processes of one host, {max(all_ns, default=1)} at "
              "most")]
    why = [w for w in [args.why] if w] + [
        "every run loads the whole DB in each process and fits one chip "
        "call with the build", "the port's --num-processes joins "
        "processes over gloo at a coordinator address, the same on one "
        "host or several"]
    if ch_ns:
        why.append("-C places every read on the host in f64, so its reads "
                   "are those that fit the call")
    if mt:
        why.append("the --mesh-tree runs are one process each, their "
                   "reads cut for time")
    res = {"device": str(dev), "card": card_line(dev), "cards": cards,
           "nproc": nproc(), "free_total_gb": free_total_gb(),
           "leaves": args.leaves, "n_nodes": n_nodes,
           "length": args.length, "eval_engine": args.eval_engine,
           "card_per_process": args.card_per_process,
           "reduced": {k: "; ".join(c[i] for c in cuts)
                       for i, k in enumerate(("what", "from", "to"))},
           "skipped": [], "fails": []}
    res["reduced"]["why"] = "; ".join(why)
    log("reduced " + json.dumps(res["reduced"]))

    def progress():
        if args.progress:
            os.makedirs(os.path.dirname(os.path.abspath(args.progress)),
                        exist_ok=True)
            with open(args.progress, "w") as fh:
                json.dump(res, fh)

    # ---- 1. inputs ------------------------------------------------------
    d = args.work
    os.makedirs(d, exist_ok=True)
    res["disk_free_gb"] = shutil.disk_usage(d).free / 1e9
    t = time.perf_counter()
    log("inputs...")
    res["n_nodes"], res["depth"] = synth_inputs(d, args.leaves, args.length)
    res["t_inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    tree = input_tree(d)
    L = tree.cs_len
    r0, Wr = site_window(L, REGION_COLS)
    se_reads = simulate_reads(tree, np.random.default_rng(READS_SEED),
                              args.reads, region=(r0, r0 + Wr)) \
        if se_ns or mt_reads else []
    se = write_fasta(os.path.join(d, "reads.fasta"), se_reads) \
        if se_ns else ""
    mt_se = [write_fasta(os.path.join(d, "mt_reads.fasta"),
                         se_reads[:mt_reads])] if mt_reads else []
    # the first reads of the --mesh-tree run again on CPU shards
    mt_cpu = write_fasta(os.path.join(d, "mt_cpu.fasta"),
                         se_reads[:min(MESH_TREE_CPU, mt_reads)]) \
        if mt_reads else ""
    del se_reads
    chim_reads = simulate_chimera_reads(
        tree, np.random.default_rng(CHIMERA_SEED), args.chimera_reads,
        (r0, r0 + Wr)) if ch_ns else []
    chim = write_reads(os.path.join(d, "chim.fasta"), chim_reads) \
        if ch_ns else ""
    pe = mt_pe = []
    if pe_ns or mt_pairs:
        fwd, rev, _, _ = simulate_pairs(
            tree, args.pairs, r0, r0 + Wr, READ_LEN,
            np.random.default_rng(PAIRS_SEED), *FRAGMENT)
        pe = write_pairs(d, "pairs", fwd, rev)
        mt_pe = write_pairs(d, "mt_pairs", fwd[:mt_pairs],
                            rev[:mt_pairs]) if mt_pairs else []
        del fwd, rev
    del tree
    res.update(cs_len=L, region=[r0, r0 + Wr], fragment_columns=FRAGMENT,
               t_reads_s=time.perf_counter() - t)
    if dev.type == "cuda":
        # built here, before any CLI starts: no child builds or waits
        from hmmufotu_tpu_torch import _cuda
        t = time.perf_counter()
        _cuda.build_all()
        res["t_kernel_build_s"] = time.perf_counter() - t
        res["kernel_build"] = "before the children, by the harness"
    progress()

    # ---- 2. build -------------------------------------------------------
    prefix, res["build"] = build_db(args, d)
    progress()
    if res["build"]["rc"] != 0:
        res["fails"].append(f"build rc {res['build']['rc']}")
        print(json.dumps(res))
        return 1

    # ---- 3. CPU references, both at once, before any card run --------
    refs = {}
    t = time.perf_counter()
    if ch_ns:
        P = min(CHIMERA_PARITY, len(chim_reads))
        refs["chim"] = start_cpu_ref(
            args, prefix, "chim_cpu", write_reads(os.path.join(
                d, "chim_cpu.fasta"), chim_reads[:P]),
            CHIMERA_ARGV + ["--chimera-out",
                            os.path.join(d, "chim_cpu.chi.tsv")])
    if mt_reads:
        refs["mesh_tree"] = start_cpu_ref(args, prefix, "mt_cpu", mt_cpu,
                                          ["--mesh-tree"], shards)
    refs = {k: finish_cpu_ref(*v) for k, v in refs.items()}
    res["t_cpu_refs_s"] = time.perf_counter() - t
    log("CPU references: " + json.dumps(refs))
    progress()

    # ---- 4-6. the runs ----------------------------------------------------
    free_gb = res["free_total_gb"]
    for mode, ns, inputs, reads in (
            ("se", se_ns, [se], args.reads), ("pe", pe_ns, pe, args.pairs),
            ("chim", ch_ns, [chim], args.chimera_reads)):
        res[mode] = {}
        base = None
        shared = dev.type == "cuda" and (not args.card_per_process
                                         or mode == "chim")
        for n in ns:
            if base is not None:
                one = base["procs"][0]
                skip = skip_reason(n, one["peak_rss_gb"],
                                   one["device_peak_gb"], free_gb, shared)
                if skip:
                    skip["mode"] = mode
                    res["skipped"].append(skip)
                    log("skipped " + json.dumps(skip))
                    continue
            r = run_n(args, f"{mode}_n{n}", n, inputs, prefix, base, reads,
                      chimera=mode == "chim")
            res[mode][str(n)] = r
            res["fails"] += r["fails"]
            log(f"{mode} N={n}: " + json.dumps(brief(r)))
            progress()
            if base is None:
                if r["fails"]:
                    break
                base = r
        mesh_runs = [("--mesh", reads, inputs, None)] \
            if mode == "se" and args.mesh and base is not None else []
        n_mt = {"se": mt_reads, "pe": mt_pairs}.get(mode)
        if n_mt:
            se_run = mode == "se"
            mesh_runs.append(("--mesh-tree", n_mt, mt_se if se_run else mt_pe,
                              refs.get("mesh_tree") if se_run else None))
        for flag, n_r, files, ref in mesh_runs:
            r = run_mesh(args, flag, mode, files, prefix, n_r, shards,
                         base, ref)
            key = "mesh" if flag == "--mesh" else f"mesh_tree_{mode}"
            res[key] = r
            res["fails"] += r["fails"]
            log(f"{mode} {flag}: " + json.dumps(brief(r)))
            progress()
        if mode == "chim" and base is not None:
            res["chimera_detection"] = detection(base["tsv"],
                                                 base["chi_tsv"])
            log("-C detection: " + json.dumps(res["chimera_detection"]))
            c = res["chimera_cpu"] = chimera_cpu(refs["chim"], P, base)
            log("-C on the CPU: " + json.dumps(c))
            if not c["ok"]:
                res["fails"].append(f"-C rows of the CPU run: {c}")
            progress()
    # every abort seen, also of a run whose gates failed for it, and the
    # processes scanned
    runs = [r for m in ("se", "pe", "chim") for r in res[m].values()] \
        + [res[k] for k in ("mesh", "mesh_tree_se", "mesh_tree_pe")
           if k in res]
    scanned = [(r["run"], p) for r in runs for p in r["procs"]] \
        + [(f"{k}_cpu", ref) for k, ref in refs.items()]
    res["processes_scanned"] = len(scanned)
    res["aborts"] = [
        {"run": run, "process_id": p["process_id"], "exit": p["exit"],
         "after_rows": p["abort_after_rows"], "lines": p["abort_lines"],
         "stderr_tail": p.get("stderr_tail")}
        for run, p in scanned if p["aborted"] or p["abort_after_rows"]]
    progress()
    print(json.dumps(res))
    return 1 if res["fails"] else 0


if __name__ == "__main__":
    sys.exit(main())
