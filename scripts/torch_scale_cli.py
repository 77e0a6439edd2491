"""The PyTorch port's normal entry points at the gg_97 shape: build, the
DB files, assign.

Where scripts/torch_scale_e2e.py drives pipeline.assign_stream in one
process, this harness runs what a user runs: the build CLI writes the
four DB files once, and the assign CLI loads them and assigns a read
file, each CLI in a process of its own.  At --leaves 75000 --length 6000
the tree has the reference database's shape (149,999 nodes x 6,000
columns).  Steps:

  1. inputs  an evolved tree (scripts/evolved_inputs.py: leaf sequences
             evolved down the tree under the bundled GTR, ~20% gap-rich
             columns, a 7-rank taxonomy) as MSA fasta, Newick and
             taxonomy files; two read files of 250 bp reads with 2%
             substitutions: amplicon (--reads, every read from one
             --region-column region, the traffic of a 16S amplicon run)
             and shotgun (--shotgun, from anywhere in the alignment: one
             batch whose union window covers every column);
  2. build   the build CLI with -s GTR --msg-dtype f32 --eval-engine
             torch: seconds of each stage from its log lines, of each DB
             file's save and its size, peak RSS, device peak;
  3. assign  the assign CLI with its default flags (the whole tree's
             messages on the device) on each read file: host clocks
             around Database.load, the placer's upload and the stream
             (stream_single), its Processed lines, peak RSS, device
             peak;
  4. parity  in the assign process, after the CLI returned: the first
             --parity reads' placements against the exact host path
             (pipeline.assign_read) on the same alignments, by the rules
             of torch_scale_e2e.py; under 95% by either fails the run;
  5. the share of amplicon reads whose placement window leaves the site
             window `assign --resident-window 1024` would have chosen
             (its rule: from the first 128 reads' alignments), from the
             TSV's alignment columns;
  6. one JSON line with every number, the card line and `free -g`'s
             total.  --progress FILE gets the numbers so far after each
             step.

    python scripts/torch_scale_cli.py --leaves 75000 --length 6000 \
        --progress out/torch_scale_cli.json
CPU smoke:
    python scripts/torch_scale_cli.py --leaves 64 --length 600 \
        --region 400 --reads 64 --shotgun 32 --batch 32 --parity 16 \
        --eval-engine numpy --device cpu --work /tmp/cli

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, SCRIPTS)

from evolved_inputs import (FASTA, TAXONOMY, TREE, input_tree,  # noqa
                            simulate_reads, synth_inputs, write_fasta)
from torch_scale_assign import site_window  # noqa: E402
from torch_scale_e2e import host_agreement, leaves_window  # noqa: E402
from torch_scale_eval import card_line, device_peak_gb, peak_rss_gb  # noqa

GG97_LEAVES = 75000
DB_SUFFIXES = (".msa.npz", ".csfm.npz", ".hmm", ".ptu.npz")
# (stage, the build CLI's log line that ends it); each stage starts where
# the one before it ended
BUILD_STAGES = (("msa_prune", "MSA database created"),
                ("csfm", "CSFM index built"),
                ("hmm", "Banded HMM profile trained"),
                ("newick_annotate_heights", "DNA substitution model loaded"),
                ("evaluate", "Final tree log-likelihood"),
                ("infer_seq", "Ancestral sequences inferred"),
                ("save", "Database saved"))
RESIDENT_COLS = 1024    # the site window of assign --resident-window 1024
RESIDENT_SAMPLE = 128   # the reads it chooses the window from
READS_SEED = 8          # the reads' rng (synth_inputs' own seed is 7)


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


class LogStamps(logging.Handler):
    """(seconds since it was made, message) of every log record."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.t0 = time.perf_counter()
        self.rows: list[tuple[float, str]] = []

    def emit(self, record):
        self.rows.append((time.perf_counter() - self.t0,
                          record.getMessage()))


def stage_seconds(rows, stages=BUILD_STAGES) -> dict:
    """Seconds of each stage from the log stamps: from the end of the
    stage before it (the start for the first) to its own last line."""
    out, t_prev = {}, 0.0
    for name, prefix in stages:
        hits = [t for t, msg in rows if msg.startswith(prefix)]
        if hits:
            out[name] = hits[-1] - t_prev
            t_prev = hits[-1]
    return out


def db_file_bytes(prefix: str) -> dict:
    return {suf: os.path.getsize(prefix + suf) for suf in DB_SUFFIXES
            if os.path.exists(prefix + suf)}


def tsv_rows(path):
    with open(path) as fh:
        return [line.rstrip("\n").split("\t") for line in fh
                if not line.startswith("#") and not line.startswith("id\t")]


def resident_oow(rows, L: int, Ws: int = RESIDENT_COLS,
                 sample: int = RESIDENT_SAMPLE) -> dict:
    """Of an assignment TSV's rows, those whose placement window leaves
    the site window `assign --resident-window Ws` would have chosen:
    its rule (cli/assign.py) from the first `sample` reads' aligned
    starts, then pipeline.dispatch_place_batch's rule for a read."""
    W = min(512, L)
    Ws = min(max(Ws, W), L)
    span = []
    for r in rows:
        st, en = int(r[6]) - 1, int(r[7]) - 1
        valid = 0 <= st <= en and math.isfinite(float(r[8]))
        span.append((st, en) if valid else None)
    scs = [s[0] for s in span[:sample] if s is not None]
    lo = min(scs) if scs else 0
    s0 = max(0, min(lo - lo % 128, L - Ws))
    n_oow = sum(s is not None and leaves_window(*s, s0, Ws, W)
                for s in span)
    n_valid = sum(s is not None for s in span)
    return {"site_window": [s0, Ws], "reads_aligned": n_valid,
            "reads_out_of_window": n_oow,
            "share": n_oow / n_valid if n_valid else None}


# ---------------------------------------------------------------------------
# the CLI processes
# ---------------------------------------------------------------------------

def clock(owner, name, clocks, key, sync=None, keep=None):
    """Wrap owner.name so each call adds its seconds to clocks[key]
    (after sync(), where given); keep(result) sees each result."""
    fn = getattr(owner, name)

    def timed(*a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        if sync:
            sync()
        clocks[key] = clocks.get(key, 0.0) + time.perf_counter() - t
        if keep:
            keep(out)
        return out

    setattr(owner, name, timed)


def child(spec: dict) -> int:
    """One CLI run (spec["cli"]: build or assign) with its clocks; prints
    one JSON line.  After assign, the parity of its first spec["parity"]
    placements against the exact host path."""
    import torch
    from hmmufotu_tpu_torch._cuda import resolve_device
    dev = resolve_device(spec["device"])
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else None
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s: %(message)s")
    stamps = LogStamps()
    logging.getLogger().addHandler(stamps)
    clocks, held = {}, {}
    if spec["cli"] == "build":
        from hmmufotu_tpu_torch.cli.build import main
        from hmmufotu_tpu_torch.hmm import ProfileHMM
        from hmmufotu_tpu_torch.index import CSFMIndex
        from hmmufotu_tpu_torch.msa import MSA
        from hmmufotu_tpu_torch.phylo import PTUnrooted
        for owner, name, key in ((MSA, "save", ".msa.npz"),
                                 (CSFMIndex, "save", ".csfm.npz"),
                                 (ProfileHMM, "to_hmmer_file", ".hmm"),
                                 (PTUnrooted, "save", ".ptu.npz")):
            clock(owner, name, clocks, "save" + key)
    else:
        from hmmufotu_tpu_torch import pipeline as pl
        from hmmufotu_tpu_torch.cli import assign
        from hmmufotu_tpu_torch.db import Database
        from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
        main = assign.main
        clock(Database, "load", clocks, "load_s",
              keep=lambda db: held.setdefault("db", db))
        clock(DevicePlacer, "__init__", clocks, "upload_s", sync=sync)
        clock(assign, "stream_single", clocks, "stream_s", sync=sync)
        stream, P = pl.assign_stream, spec["parity"]
        seen = SimpleNamespace(alns=[], best=[])

        def recording(*a, **kw):
            for alns, best in stream(*a, **kw):
                seen.alns.extend(alns[:max(0, P - len(seen.alns))])
                seen.best.extend(best[:max(0, P - len(seen.best))])
                yield alns, best

        pl.assign_stream = recording
    if sync:
        torch.cuda.reset_peak_memory_stats(dev)
    rc = main(spec["argv"], device=spec["device"])
    out = {"rc": rc, "peak_rss_gb": peak_rss_gb(),
           "device_peak_gb": device_peak_gb(dev),
           "clocks": clocks, "stamps": stamps.rows}
    if spec["cli"] == "assign" and rc == 0 and P:
        out.update(parity(pl, held["db"].ptu, seen, spec["tsv"]))
    print(json.dumps(out), flush=True)
    return 0


def parity(pl, tree, seen, tsv) -> dict:
    """The recorded first placements against the exact host path, and
    against the TSV's rows (the same branch and loglik text)."""
    rows = tsv_rows(tsv)
    n_rows_equal = sum(
        (b is None and r[10] == "-1") or (b is not None and r[10] ==
                                          b.get_id() and r[15] ==
                                          f"{b.loglik:g}")
        for b, r in zip(seen.best, rows))
    t = time.perf_counter()
    got = host_agreement(pl, tree, seen.alns, seen.best,
                         range(len(seen.alns)), min(512, tree.cs_len),
                         SimpleNamespace(max_nseed=pl.DEFAULT_MAX_NSEED),
                         "parity")
    out = {"parity_" + k: v for k, v in got.items()}
    out["t_parity_s"] = time.perf_counter() - t
    out["parity_tsv_rows_equal"] = int(n_rows_equal)
    out["parity_rows"] = len(seen.best)
    return out


def run_child(cli: str, argv: list[str], args, tsv: str = "") -> dict:
    """A CLI run in a process of its own; its JSON line, with its wall
    seconds and exit code."""
    spec = {"cli": cli, "argv": argv, "device": args.device,
            "parity": args.parity, "tsv": tsv}
    log(f"{cli} {' '.join(argv)}")
    t = time.perf_counter()
    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--child", json.dumps(spec)],
                       stdout=subprocess.PIPE, text=True)
    wall = time.perf_counter() - t
    lines = p.stdout.strip().splitlines()
    try:
        out = json.loads(lines[-1])
    except (IndexError, ValueError):
        out = {"rc": None}
    out["exit"] = p.returncode
    out["wall_s"] = wall
    return out


# ---------------------------------------------------------------------------

def free_total_gb() -> int | None:
    """The total of `free -g`'s Mem line."""
    try:
        out = subprocess.run(["free", "-g"], capture_output=True,
                             text=True, timeout=30).stdout
    except OSError:
        return None
    for line in out.splitlines():
        if line.startswith("Mem:"):
            return int(line.split()[1])
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--leaves", type=int, default=GG97_LEAVES)
    ap.add_argument("--length", type=int, default=6000)
    ap.add_argument("--reads", type=int, default=20480,
                    help="amplicon reads, all from one --region")
    ap.add_argument("--shotgun", type=int, default=2048,
                    help="reads from anywhere in the alignment")
    ap.add_argument("--region", type=int, default=1024,
                    help="columns of the amplicon region (placed as the "
                         "scale harnesses' site window)")
    ap.add_argument("--batch", type=int, default=0,
                    help="assign -b (0: the CLI's default)")
    ap.add_argument("--parity", type=int, default=128)
    ap.add_argument("--eval-engine", default="torch",
                    choices=["torch", "numpy"])
    ap.add_argument("--work", default=os.path.join(
        REPO, ".bench", "torch_scale_cli"),
        help="directory of the inputs, DB files and TSVs")
    ap.add_argument("--progress", default="",
                    help="JSON file holding the numbers so far")
    ap.add_argument("--why", default="",
                    help="why --leaves is below the gg_97 shape's")
    ap.add_argument("--device", default="cuda",
                    help="cuda; cpu only when asked for")
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(json.loads(args.child))

    from hmmufotu_tpu_torch._cuda import resolve_device
    dev = resolve_device(args.device)
    res = {"device": str(dev), "card": card_line(dev),
           "free_total_gb": free_total_gb(), "leaves": args.leaves,
           "length": args.length, "eval_engine": args.eval_engine}
    if args.leaves < GG97_LEAVES:
        res["reduced"] = {"from": f"{2 * GG97_LEAVES - 1} nodes",
                          "to": f"{2 * args.leaves - 1} nodes",
                          "why": args.why}
        log("reduced " + json.dumps(res["reduced"]))

    def progress():
        if args.progress:
            os.makedirs(os.path.dirname(os.path.abspath(args.progress)),
                        exist_ok=True)
            with open(args.progress, "w") as fh:
                json.dump(res, fh)

    # ---- 1. inputs ------------------------------------------------------
    d = args.work
    t = time.perf_counter()
    log("inputs...")
    res["n_nodes"], res["depth"] = synth_inputs(d, args.leaves, args.length)
    res["t_inputs_s"] = time.perf_counter() - t
    res["input_bytes"] = {f: os.path.getsize(os.path.join(d, f))
                          for f in (FASTA, TREE, TAXONOMY)}
    t = time.perf_counter()
    tree = input_tree(d)
    L = tree.cs_len
    r0, Wr = site_window(L, args.region)
    rng = np.random.default_rng(READS_SEED)
    files = {"amplicon": simulate_reads(tree, rng, args.reads,
                                        region=(r0, r0 + Wr)),
             "shotgun": simulate_reads(tree, rng, args.shotgun)}
    del tree
    for name, reads in files.items():
        files[name] = write_fasta(os.path.join(d, f"{name}.fasta"), reads)
    res.update(cs_len=L, amplicon_region=[r0, r0 + Wr],
               t_reads_s=time.perf_counter() - t)
    if dev.type == "cuda":
        # built before the CLIs run, so that no stream pays for nvcc
        from hmmufotu_tpu_torch import _cuda
        t = time.perf_counter()
        _cuda.build_all()
        res["t_kernel_build_s"] = time.perf_counter() - t
    progress()

    # ---- 2. build -------------------------------------------------------
    prefix = os.path.join(d, "db")
    b = run_child("build", [
        os.path.join(d, FASTA), os.path.join(d, TREE), "-a",
        os.path.join(d, TAXONOMY), "-n", prefix, "-s", "GTR",
        "--msg-dtype", "f32", "--eval-engine", args.eval_engine], args)
    b["stages_s"] = stage_seconds(b.pop("stamps", []))
    b["file_bytes"] = db_file_bytes(prefix)
    res["build"] = b
    log("build: " + json.dumps(b))
    progress()
    if b["rc"] != 0:
        print(json.dumps(res))
        return 1

    # ---- 3-4. assign, parity --------------------------------------------
    ok = True
    for name, path in files.items():
        tsv = os.path.join(d, f"{name}.tsv")
        argv_a = [prefix, path, "-o", tsv] + (
            ["-b", str(args.batch)] if args.batch else [])
        a = run_child("assign", argv_a, args, tsv)
        stamps = a.pop("stamps", [])
        a["processed"] = [[t, int(m.split()[1])] for t, m in stamps
                          if m.startswith("Processed ")]
        n = args.reads if name == "amplicon" else args.shotgun
        a["reads"] = n
        if a.get("clocks", {}).get("stream_s"):
            a["reads_per_s"] = n / a["clocks"]["stream_s"]
        if a["rc"] == 0:
            a["out_of_window"] = resident_oow(tsv_rows(tsv), L)
        res[name] = a
        log(f"{name}: " + json.dumps(a))
        progress()
        P = a.get("parity_reads", 0)
        ok = ok and a["rc"] == 0 and (not args.parity or (
            P > 0 and min(a["parity_cnode_match"], a["parity_loglik_match"])
            >= 0.95 * P and a["parity_tsv_rows_equal"] == a["parity_rows"]))

    print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
