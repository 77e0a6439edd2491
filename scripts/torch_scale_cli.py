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
             torch (--gamma: -V -k 4, the dGamma4 rate mixture, whose
             alpha estimate and second evaluate are stages of their
             own): seconds of each stage from its log lines, of each DB
             file's save and its size, peak RSS, device peak;
  3. assign  the assign CLI with its default flags (the whole tree's
             messages on the device) on each read file: host clocks
             around Database.load (and by file: .msa.npz, .csfm.npz,
             .hmm, .ptu.npz; the .ptu.npz by member: msg_up, msg_down,
             the rest; with the threads the npz reader used), the
             placer's upload and the stream
             (stream_single), its Processed lines and the rates of the
             first and the last 10 batches, peak RSS, device peak, the
             loaded messages' dtype, the placer's rate count, the TSV's
             bytes, and on a card K1-K3 launches and CUDA-event ms;
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
BASELINE config #3 (a GTR+dGamma4 DB, 1,000,000 single-end amplicon
reads, one card; `reduced` names every cut of it):
    python scripts/torch_scale_cli.py --leaves 75000 --length 6000 \
        --reads 1000000 --shotgun 0 --gamma --progress out/config3.json
CPU smoke:
    python scripts/torch_scale_cli.py --leaves 64 --length 600 \
        --region 400 --reads 64 --shotgun 32 --batch 32 --parity 16 \
        --eval-engine numpy --device cpu --work /tmp/cli

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import math
import os
import resource
import shutil
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
from torch_scale_e2e import (ShardClock, clip_to_device_window,  # noqa
                             host_agreement, leaves_window)
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
# with -V: the child logs EVALUATED after each evaluate returns; the alpha
# estimate (the mutation count) ends at the build's alpha line, and the
# second evaluate, under the rate mixture, at its final loglik
EVALUATED = "torch_scale_cli: evaluate returned"
GAMMA_STAGES = (BUILD_STAGES[:4]
                + (("evaluate", EVALUATED + " 1"),
                   ("alpha_estimate", "Estimated dGamma alpha"),
                   ("evaluate_dgamma", "Final tree log-likelihood"))
                + BUILD_STAGES[5:])
DG_K = 4                # rate categories of --gamma (the build's -k)
CONFIG3_READS = 1_000_000   # BASELINE config #3's reads
RATE_BATCHES = 10       # batches of the first and last stream rates
RESIDENT_COLS = 1024    # the site window of assign --resident-window 1024
RESIDENT_SAMPLE = 128   # the reads it chooses the window from
READS_SEED = 8          # the reads' rng (synth_inputs' own seed is 7)
SHAPE_FILE = "db_shape.json"   # the shape of the DB files in a --work


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


def tsv_rows(path, limit: int | None = None, fields: int = -1):
    """The body rows of an assignment TSV, split into fields (the first
    `fields` and the rest, where given), one at a time: the first
    `limit`, or all."""
    with open(path) as fh:
        body = (line for line in fh
                if not line.startswith("#") and not line.startswith("id\t"))
        for line in itertools.islice(body, limit):
            yield line.rstrip("\n").split("\t", fields)


def resident_oow(rows, L: int, Ws: int = RESIDENT_COLS,
                 sample: int = RESIDENT_SAMPLE) -> dict:
    """Of an assignment TSV's rows (any iterable), those whose placement
    window leaves the site window `assign --resident-window Ws` would
    have chosen: its rule (cli/assign.py) from the first `sample` reads'
    aligned starts, then pipeline.dispatch_place_batch's rule for a
    read."""
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
    return {"site_window": [s0, Ws], "rows": len(span),
            "reads_aligned": n_valid,
            "reads_out_of_window": n_oow,
            "share": n_oow / n_valid if n_valid else None}


def stream_rates(processed, stream_s: float, k: int = RATE_BATCHES):
    """From the Processed timeline [(seconds, reads so far)]: the first
    batch's seconds from the stream's start (its last line less its
    clock), and reads/s over the first and over the last k full batches
    after it, each between Processed lines.  The first batch also fills
    the double buffer, and a short last batch, placed while the host
    wrote the one before, ends moments after it: neither is counted."""
    t = [p[0] for p in processed]
    n = [p[1] for p in processed]
    t_start = t[-1] - stream_s
    if len(n) > 2 and n[-1] - n[-2] < n[1] - n[0]:
        t, n = t[:-1], n[:-1]
    k = min(k, (len(n) - 1) // 2)
    if k == 0:
        return None
    first = (n[k] - n[0]) / (t[k] - t[0])
    last = (n[-1] - n[-1 - k]) / (t[-1] - t[-1 - k])
    return {"batches": k, "first_batch_s": t[0] - t_start,
            "first_reads_per_s": first, "last_reads_per_s": last,
            "last_over_first": last / first}


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


def clock_iter(owner, name, clocks, key):
    """Wrap the generator function owner.name so that the time spent
    inside it (each step, not the caller's loop body) adds to
    clocks[key]."""
    fn = getattr(owner, name)

    def timed(*a, **kw):
        it = fn(*a, **kw)
        while True:
            t = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                clocks[key] = (clocks.get(key, 0.0)
                               + time.perf_counter() - t)
            yield item

    setattr(owner, name, timed)


def kernel_events():
    """Count and time every launch of the main path's kernels (K1-K3)
    with CUDA events on the launching stream (the current stream of the
    card its tensors lie on), from 0.  Returns finish(): after the run,
    each kernel's launches and summed milliseconds, and its launches by
    card."""
    import torch
    from hmmufotu_tpu_torch.hmm import cuda_viterbi as cv
    from hmmufotu_tpu_torch.phylo import cuda_place as cp
    events, by_card = {}, {}

    def timed(key, mod, attr):
        fn = getattr(mod, attr)
        fn.launches.reset()
        events[key] = []
        by_card[key] = {}

        def wrapper(*args, **kw):
            card = next((a.device for a in args
                         if torch.is_tensor(a) and a.is_cuda), None)
            stream = torch.cuda.current_stream(card)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record(stream)
            out = fn(*args, **kw)
            e.record(stream)
            events[key].append((s, e))
            c = str(stream.device.index)
            by_card[key][c] = by_card[key].get(c, 0) + 1
            return out
        # the launcher counts through its module-level name
        wrapper.launches = fn.launches
        setattr(mod, attr, wrapper)
        return fn.launches

    counts = {"viterbi_traced": timed("viterbi_traced", cv,
                                      "viterbi_traced_cuda"),
              "est": timed("est", cp, "est_cuda"),
              "sep_optimize": timed("sep_optimize", cp, "sep_cuda")}

    def finish():
        torch.cuda.synchronize()
        return {"launches": {k: c.n for k, c in counts.items()},
                "kernel_ms": {k: sum(s.elapsed_time(e) for s, e in ev)
                              for k, ev in events.items()},
                "launches_by_card": by_card}

    return finish


class MeshClocks:
    """A mesh run's placement (assign --mesh or --mesh-tree) by shard:
    each card's busy ms from CUDA events around every place_batch_device
    on it and the host seconds each call took to enqueue (ShardClock);
    under --mesh-tree also tree_shards' seconds (clocks tree_shards_s,
    the cards synchronized after the first call, which builds the
    shards; later calls find them built), each shard's device, first
    node and message bytes, and the host merge of the shards' grids
    (clocks merge_s, pipeline.merge_mp_candidates)."""

    def __init__(self, pl, clocks, cuda: bool):
        import torch
        from hmmufotu_tpu_torch.parallel import sharding
        self.cuda, self.shards = cuda, []
        build = sharding.tree_shards

        def shards(mesh, placer):
            t = time.perf_counter()
            out = build(mesh, placer)
            if not self.shards:
                if cuda:
                    for d in set(mesh.devices):
                        torch.cuda.synchronize(d)
                self.shards = [
                    {"device": str(dt.msg_up.device), "node_lo": lo,
                     "msg_bytes": dt.msg_up.nbytes + dt.msg_down.nbytes}
                    for lo, dt, _ in out]
            clocks["tree_shards_s"] = (clocks.get("tree_shards_s", 0.0)
                                       + time.perf_counter() - t)
            return out

        sharding.tree_shards = shards
        clock(pl, "merge_mp_candidates", clocks, "merge_s")
        self.clock = ShardClock(cuda).__enter__()

    def result(self) -> dict:
        out = {"card_busy_ms": self.clock.busy_ms() if self.cuda else {},
               "shard_enqueue_s": self.clock.enqueue_s}
        if self.shards:
            out["shards"] = self.shards
        return out


def cpu_mesh(n: int):
    """The assign CLI's mesh as n CPU shards (its make_mesh patched, as
    tests/test_torch_cuda.py does): a CPU run of a mesh flag with as many
    shards as the cards of the run it checks."""
    from hmmufotu_tpu_torch import parallel
    parallel.make_mesh = lambda *a, **kw: parallel.sharding.make_mesh(
        n, device="cpu")


def load_clocks(files: dict, members: dict, read: list):
    """Clock Database.load by file (files[suffix]: MSA, CSFM index, HMM,
    tree) and the .ptu.npz's reads by member (members: msg_up, msg_down,
    the rest); read gets the name of every .ptu.npz member read."""
    from hmmufotu_tpu_torch.hmm import ProfileHMM
    from hmmufotu_tpu_torch.index import CSFMIndex
    from hmmufotu_tpu_torch.io.npz import NpzReader
    from hmmufotu_tpu_torch.msa import MSA
    from hmmufotu_tpu_torch.phylo import PTUnrooted
    for owner, name, key in ((MSA, "load", ".msa.npz"),
                             (CSFMIndex, "load", ".csfm.npz"),
                             (ProfileHMM, "from_hmmer_file", ".hmm"),
                             (PTUnrooted, "load", ".ptu.npz")):
        clock(owner, name, files, key)
    get = NpzReader.__getitem__

    def timed(z, key):
        t = time.perf_counter()
        out = get(z, key)
        if z.path.endswith(".ptu.npz"):
            k = key if key in ("msg_up", "msg_down") else "rest"
            members[k] = members.get(k, 0.0) + time.perf_counter() - t
            read.append(key)
        return out

    NpzReader.__getitem__ = timed


def child(spec: dict) -> int:
    """One CLI run (spec["cli"]: build, assign, sum or merge) with its
    clocks; prints one JSON line.  After assign, the parity of its first
    spec["parity"] placements against the exact host path; with
    spec["kernels"] also each main-path kernel's launches and summed
    CUDA-event milliseconds."""
    import torch
    from hmmufotu_tpu_torch._cuda import resolve_device
    from hmmufotu_tpu_torch.io.npz import host_threads
    dev = resolve_device(spec["device"])
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else None
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s: %(message)s")
    stamps = LogStamps()
    logging.getLogger().addHandler(stamps)
    clocks, held = {}, {}
    kernels = mesh = None
    files, members, read = {}, {}, []
    if spec["cli"] != "build":
        load_clocks(files, members, read)
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
        n_eval = itertools.count(1)
        clock(PTUnrooted, "evaluate", clocks, "evaluate_s", sync=sync,
              keep=lambda _: logging.getLogger().info(
                  "%s %d", EVALUATED, next(n_eval)))
    elif spec["cli"] in ("sum", "merge"):
        # host tools: they take no device
        from hmmufotu_tpu_torch.alphabet import DNA
        from hmmufotu_tpu_torch.cli import merge, sum as sum_cli
        from hmmufotu_tpu_torch.db import Database
        from hmmufotu_tpu_torch.otu import OTUObserved, OTUTable
        from hmmufotu_tpu_torch.phylo import PTUnrooted
        clock(PTUnrooted, "to_newick", clocks, "tree_s")
        if spec["cli"] == "sum":
            clock(Database, "load", clocks, "load_s")
            main = sum_cli.main
            clock_iter(sum_cli, "parse_assignment_tsv", clocks, "parse_s")
            clock(DNA, "encode_upper", clocks, "encode_s")
            clock(OTUObserved, "add_seq", clocks, "accumulate_s")
            clock(OTUTable, "add_otu", clocks, "table_s")
            clock(OTUTable, "save_table", clocks, "table_s")
            clock(PTUnrooted, "infer_post_cs", clocks, "consensus_s")
        else:
            main = merge.main
            # merge -t reads the tree's topology alone
            clock(Database, "load_topology", clocks, "load_s")
            clock(OTUTable, "load_table", clocks, "tables_load_s")
            clock(OTUTable, "__iadd__", clocks, "tables_add_s")
    else:
        from hmmufotu_tpu_torch import pipeline as pl
        from hmmufotu_tpu_torch.cli import assign
        from hmmufotu_tpu_torch.db import Database
        from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
        main = assign.main
        # the aligner's stage clocks (hmm.viterbi.TIMING), filled by the
        # tracer HMMUFOTU_TIMING turns on; clear() takes the switch up
        os.environ["HMMUFOTU_TIMING"] = "1"
        import hmmufotu_tpu_torch.hmm.viterbi as viterbi
        viterbi.TIMING.clear()
        clock(Database, "load", clocks, "load_s",
              keep=lambda db: held.setdefault("db", db))
        clock(DevicePlacer, "__init__", clocks, "upload_s", sync=sync)
        made = DevicePlacer.__init__

        def init(placer, *a, **kw):
            made(placer, *a, **kw)
            held["placer"] = placer

        DevicePlacer.__init__ = init
        clock(assign, "write_gathered", clocks, "gather_s")
        stream, P = pl.assign_stream, spec["parity"]
        seen = SimpleNamespace(alns=[], best=[], paired=False)

        def recording(*a, **kw):
            for alns, best in stream(*a, **kw):
                seen.alns.extend(alns[:max(0, P - len(seen.alns))])
                seen.best.extend(best[:max(0, P - len(seen.best))])
                yield alns, best

        pl.assign_stream = recording
        place_batch = pl.assign_batch_device

        def placing(tree, placer, alns, *a, **kw):
            # the batch loop's merged pairs, as the device placed them
            best = place_batch(tree, placer, alns, *a, **kw)
            seen.paired = True
            seen.alns.extend(alns[:max(0, P - len(seen.alns))])
            seen.best.extend(best[:max(0, P - len(seen.best))])
            return best

        pl.assign_batch_device = placing
        stages = StreamStages(pl, assign, clocks, sync,
                              chimera="-C" in spec["argv"])
        if spec.get("kernels") and dev.type == "cuda":
            kernels = kernel_events()
        if spec.get("cpu_shards"):
            cpu_mesh(spec["cpu_shards"])
        if {"--mesh", "--mesh-tree"} & set(spec["argv"]):
            mesh = MeshClocks(pl, clocks, sync is not None)
    # a mesh run's peaks on every card it sees
    cards = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())] \
        if sync and mesh else [dev]
    if sync and spec["cli"] in ("build", "assign"):
        for c in cards:
            # a card's allocator exists once something is allocated there
            torch.empty(1, device=c)
            torch.cuda.reset_peak_memory_stats(c)
    started_at = time.time()
    rc = (main(spec["argv"]) if spec["cli"] in ("sum", "merge")
          else main(spec["argv"], device=spec["device"]))
    out = {"rc": rc, "peak_rss_gb": peak_rss_gb(),
           "device_peak_gb": device_peak_gb(dev),
           "clocks": clocks, "stamps": stamps.rows,
           "npz_threads": host_threads(),
           "torch_threads": torch.get_num_threads(),
           "cards_seen": torch.cuda.device_count() if sync else 0,
           "cpu_s": cpu_seconds(), "main_started_at": started_at,
           "main_returned_at": time.time()}
    if spec["cli"] == "assign":
        out.update(stream_stages_s=stages.s, stream_cpu_s=stages.cpu_s,
                   viterbi_timing_s=stages.timing)
    if mesh:
        out.update(mesh.result())
        if sync:
            out["device_peaks_gb"] = [device_peak_gb(c) for c in cards]
    if spec["cli"] != "build":
        out.update(load_files_s=files, load_ptu_members_s=members,
                   ptu_members_read=read)
    if kernels:
        out.update(kernels())
    if "db" in held:
        ptu = held["db"].ptu
        out.update(msg_dtype=str(ptu.msg_up.dtype),
                   dg_alpha=None if ptu.dg is None else ptu.dg.alpha)
    if "placer" in held:
        out["placer_rates"] = int(held["placer"].dt.rates.numel())
    if spec["cli"] == "assign" and rc == 0 and P:
        out.update(parity(pl, held["db"].ptu, seen, spec["tsv"]))
    print(json.dumps(out), flush=True)
    return 0


def cpu_seconds() -> float:
    """User + system CPU seconds of this process so far."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


class StreamStages:
    """Host clocks inside the assign CLI's stream (stream_single, or
    batch_loop for pairs, --mesh and --mesh-tree), from wrappers of the
    functions it calls; the package is not edited.  Each function's
    seconds are summed on the thread that runs it: in stream_single the
    seed search (seed_s) and the DP launch (dp_dispatch_s) run on
    assign_stream's worker thread; the download and alignment strings
    (strings_s, ViterbiAligner.finalize_batch), the placement's launch
    and download (place_dispatch_s, place_collect_s), and the time
    inside the generator (gen_s, its waits for the worker included) on
    the main thread, whose rest of the stream is the TSV rows
    (rows_s).  In
    batch_loop: the alignments (align_s, seed_s in it), the placement
    (place_s; under --mesh-tree the shards' placements, their grids'
    download and the host merge) and the rest (rows_s: orientation,
    merge, TSV rows); with chimera (an assign -C run) the placement is
    on the host, and its clocks are those of the seed search over every
    node (get_seed_s), the chimera check (chimera_s; in it the segments'
    estimate, filter and place, chimera_segments_s, and besides them the
    two alternatives and the segments' seed p-distances) and the whole
    read's estimate, filter and place after it (host_sep_s).
    align_out_s: the --align-out records.  Only calls made while the
    stream runs count (the strand test before it does not); the
    stream's own clock (clocks["stream_s"]) ends after a device sync.
    cpu_s is the process's CPU seconds over the stream, timing the
    aligner's TIMING keys over it."""

    def __init__(self, pl, assign, clocks, sync, chimera=False):
        from hmmufotu_tpu_torch.hmm import ViterbiAligner
        from hmmufotu_tpu_torch.hmm import viterbi
        from hmmufotu_tpu_torch.seq import SeqWriter
        self.s, self.on, self.cpu_s, self.timing = {}, False, None, {}
        self.in_chimera = False
        self.viterbi = viterbi
        self.inner = ("align_s", "place_s")
        for owner, name, key in (
                (pl, "batch_find_seed_vpaths", "seed_s"),
                (ViterbiAligner, "dispatch_batch", "dp_dispatch_s"),
                (ViterbiAligner, "finalize_batch", "strings_s"),
                (pl, "dispatch_place_batch", "place_dispatch_s"),
                (pl, "collect_place_batch", "place_collect_s"),
                (pl, "align_reads", "align_s"),
                (pl, "assign_batch_device", "place_s"),
                (pl, "assign_batch_device_tree", "place_s"),
                (SeqWriter, "write", "align_out_s")):
            self.wrap(owner, name, key)
        if chimera:
            self.chimera(pl, assign)
        # assign_stream runs only inside stream_single
        clock_iter(pl, "assign_stream", self.s, "gen_s")
        for name in ("stream_single", "batch_loop"):
            self.stream(assign, name, clocks, sync)

    def chimera(self, pl, assign):
        """-C's host placement: get_seed_s, chimera_s, and the host SEP
        split by whether check_chimera runs (chimera_segments_s, else
        host_sep_s)."""
        self.wrap(pl, "get_seed", "get_seed_s")
        for name in ("estimate_seq", "filter_placements", "place_seq"):
            self.wrap(pl, name, "host_sep_s", "chimera_segments_s")
        check = assign.check_chimera

        def checking(*a, **kw):
            self.in_chimera = True
            try:
                return check(*a, **kw)
            finally:
                self.in_chimera = False

        assign.check_chimera = checking
        self.wrap(assign, "check_chimera", "chimera_s")
        self.inner += ("get_seed_s", "chimera_s", "host_sep_s")

    def wrap(self, owner, name, key, chimera_key=None):
        """Sum owner.name's seconds under key, or under chimera_key
        (where given) while check_chimera runs."""
        fn = getattr(owner, name)

        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                k = chimera_key if chimera_key and self.in_chimera else key
                if self.on:
                    self.s[k] = self.s.get(k, 0.0) + time.perf_counter() - t

        setattr(owner, name, timed)

    def stream(self, owner, name, clocks, sync):
        fn = getattr(owner, name)

        def timed(*a, **kw):
            timing0 = dict(self.viterbi.TIMING)
            cpu0, t = cpu_seconds(), time.perf_counter()
            self.on = True
            try:
                out = fn(*a, **kw)
                if sync:
                    sync()
            finally:
                self.on = False
            dt = time.perf_counter() - t
            clocks["stream_s"] = clocks.get("stream_s", 0.0) + dt
            self.cpu_s = cpu_seconds() - cpu0
            self.timing = {k: v - timing0.get(k, 0.0)
                           for k, v in self.viterbi.TIMING.items()}
            inner = ("gen_s",) if "gen_s" in self.s else self.inner
            self.s["rows_s"] = dt - sum(self.s.get(k, 0.0) for k in inner)
            return out

        setattr(owner, name, timed)


def parity(pl, tree, seen, tsv) -> dict:
    """The recorded first placements against the exact host path, and
    (single-end reads, one TSV row a read) against the TSV's rows (the
    same branch and loglik text).  Merged pairs are held against the
    host path on the columns the device scores (clip_to_device_window),
    as scripts/torch_scale_e2e.py --paired gates them."""
    W = min(512, tree.cs_len)
    alns = seen.alns
    if seen.paired:
        alns = [clip_to_device_window(a, W) for a in alns]
    else:
        rows = tsv_rows(tsv, len(seen.best))
        n_rows_equal = sum(
            (b is None and r[10] == "-1") or (b is not None and r[10] ==
                                              b.get_id() and r[15] ==
                                              f"{b.loglik:g}")
            for b, r in zip(seen.best, rows))
    t = time.perf_counter()
    got = host_agreement(pl, tree, alns, seen.best, range(len(alns)), W,
                         SimpleNamespace(max_nseed=pl.DEFAULT_MAX_NSEED),
                         "parity")
    out = {"parity_" + k: v for k, v in got.items()}
    out["t_parity_s"] = time.perf_counter() - t
    out["parity_rows"] = len(seen.best)
    # a TSV row of a pair is written only for a well oriented one
    out["parity_tsv_rows_equal"] = None if seen.paired \
        else int(n_rows_equal)
    return out


def start_child(cli: str, argv: list[str], args, tsv: str = "",
                parity: int | None = None, kernels: bool = False,
                env: dict | None = None, stderr=None,
                device: str | None = None, cpu_shards: int = 0):
    """Start a CLI run in a process of its own (see run_child); env
    entries are added to this process's environment, stderr is a file
    for its standard error (default: this process's), device overrides
    args.device, cpu_shards > 0 makes the CLI's mesh that many CPU
    shards (cpu_mesh).  Returns what finish_child takes."""
    spec = {"cli": cli, "argv": argv,
            "device": args.device if device is None else device,
            "parity": args.parity if parity is None else parity,
            "tsv": tsv, "kernels": kernels, "cpu_shards": cpu_shards}
    log(f"{cli} {' '.join(argv)}"
        + (f" ({' '.join(f'{k}={v}' for k, v in env.items())})"
           if env else ""))
    p = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                          "--child", json.dumps(spec)],
                         stdout=subprocess.PIPE, stderr=stderr, text=True,
                         env=dict(os.environ, **env) if env else None)
    return p, time.perf_counter()


def finish_child(started) -> dict:
    """Wait for a child of start_child; its JSON line, with its wall
    seconds and exit code (rc None when it printed none)."""
    p, t = started
    stdout, _ = p.communicate()
    wall = time.perf_counter() - t
    lines = stdout.strip().splitlines()
    try:
        out = json.loads(lines[-1])
    except (IndexError, ValueError):
        out = {"rc": None}
    out["exit"] = p.returncode
    out["wall_s"] = wall
    return out


def run_child(cli: str, argv: list[str], args, tsv: str = "",
              parity: int | None = None, kernels: bool = False) -> dict:
    """A CLI run in a process of its own; its JSON line, with its wall
    seconds and exit code.  parity overrides args.parity; kernels asks
    an assign run for its kernels' launches and milliseconds."""
    return finish_child(start_child(cli, argv, args, tsv, parity,
                                    kernels))


# ---------------------------------------------------------------------------

def build_db(args, d: str, reuse: bool = False) -> tuple[str, dict]:
    """The build CLI (-s GTR --msg-dtype f32 --eval-engine
    args.eval_engine) on synth_inputs' files in d, in a process of its
    own: (the DB prefix, the build's numbers).  reuse: skip it when d
    holds the four DB files of this shape (d/db_shape.json), as a
    successful build leaves them."""
    prefix = os.path.join(d, "db")
    shape = {"leaves": args.leaves, "length": args.length,
             "eval_engine": args.eval_engine}
    shape_path = os.path.join(d, SHAPE_FILE)
    have = db_file_bytes(prefix)
    if reuse and len(have) == 4 and os.path.exists(shape_path) \
            and json.load(open(shape_path)) == shape:
        log("build: reusing " + prefix)
        return prefix, {"reused": True, "rc": 0, "file_bytes": have}
    if os.path.exists(shape_path):
        os.unlink(shape_path)
    b = run_child("build", [
        os.path.join(d, FASTA), os.path.join(d, TREE), "-a",
        os.path.join(d, TAXONOMY), "-n", prefix, "-s", "GTR",
        "--msg-dtype", "f32", "--eval-engine", args.eval_engine], args)
    b["stages_s"] = stage_seconds(b.pop("stamps", []))
    b["file_bytes"] = db_file_bytes(prefix)
    log("build: " + json.dumps(b))
    if b["rc"] == 0:
        with open(shape_path, "w") as fh:
            json.dump(shape, fh)
    return prefix, b


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
                    help="reads from anywhere in the alignment (0: the "
                         "amplicon file alone)")
    ap.add_argument("--region", type=int, default=1024,
                    help="columns of the amplicon region (placed as the "
                         "scale harnesses' site window)")
    ap.add_argument("--batch", type=int, default=0,
                    help="assign -b (0: the CLI's default)")
    ap.add_argument("--parity", type=int, default=128)
    ap.add_argument("--gamma", action="store_true",
                    help=f"build with -V -k {DG_K} (the dGamma4 rate "
                         "mixture): BASELINE config #3 with --reads "
                         f"{CONFIG3_READS}")
    ap.add_argument("--eval-engine", default="torch",
                    choices=["torch", "numpy"])
    ap.add_argument("--work", default=os.path.join(
        REPO, ".bench", "torch_scale_cli"),
        help="directory of the inputs, DB files and TSVs")
    ap.add_argument("--progress", default="",
                    help="JSON file holding the numbers so far")
    ap.add_argument("--why", default="",
                    help="why --leaves (or, with --gamma, --reads or "
                         "--parity) is below the configuration's")
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
           "length": args.length, "eval_engine": args.eval_engine,
           "gamma": args.gamma}
    cuts = [("nodes", 2 * GG97_LEAVES - 1, 2 * args.leaves - 1)]
    if args.gamma:
        # config #3: its reads, and the parity of the CLI harnesses
        cuts += [("reads", CONFIG3_READS, args.reads),
                 ("parity", 128, args.parity)]
    cuts = [c for c in cuts if c[2] < c[1]]
    if cuts:
        res["reduced"] = {"what": "; ".join(c[0] for c in cuts),
                          "from": "; ".join(f"{c[1]} {c[0]}" for c in cuts),
                          "to": "; ".join(f"{c[2]} {c[0]}" for c in cuts),
                          "why": args.why}
        log("reduced " + json.dumps(res["reduced"]))
    else:
        res["reduced"] = {}

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
    res["input_bytes"] = {f: os.path.getsize(os.path.join(d, f))
                          for f in (FASTA, TREE, TAXONOMY)}
    t = time.perf_counter()
    tree = input_tree(d)
    L = tree.cs_len
    r0, Wr = site_window(L, args.region)
    rng = np.random.default_rng(READS_SEED)
    files = {"amplicon": simulate_reads(tree, rng, args.reads,
                                        region=(r0, r0 + Wr))}
    if args.shotgun:
        files["shotgun"] = simulate_reads(tree, rng, args.shotgun)
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
        "--msg-dtype", "f32", "--eval-engine", args.eval_engine]
        + (["-V", "-k", str(DG_K)] if args.gamma else []), args)
    stamps = b.pop("stamps", [])
    b["stages_s"] = stage_seconds(
        stamps, GAMMA_STAGES if args.gamma else BUILD_STAGES)
    alpha = [m for _, m in stamps if m.startswith("Estimated dGamma alpha")]
    if alpha:
        b["dg_alpha"] = float(alpha[-1].split("=")[-1])
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
        a = run_child("assign", argv_a, args, tsv,
                      kernels=dev.type == "cuda")
        stamps = a.pop("stamps", [])
        a["processed"] = [[t, int(m.split()[1])] for t, m in stamps
                          if m.startswith("Processed ")]
        n = args.reads if name == "amplicon" else args.shotgun
        a["reads"] = n
        stream_s = a.get("clocks", {}).get("stream_s")
        if stream_s:
            a["reads_per_s"] = n / stream_s
            a["rates"] = stream_rates(a["processed"], stream_s)
        a["tsv_bytes"] = os.path.getsize(tsv) if os.path.exists(tsv) \
            else None
        if a["rc"] == 0:
            a["out_of_window"] = resident_oow(tsv_rows(tsv, fields=9), L)
            a["tsv_rows"] = a["out_of_window"]["rows"]
        res[name] = a
        log(f"{name}: " + json.dumps(
            {k: v for k, v in a.items() if k != "processed"}))
        progress()
        P = a.get("parity_reads", 0)
        ok = ok and a["rc"] == 0 and a["exit"] == 0 \
            and a.get("tsv_rows") == n and (not args.parity or (
                P > 0 and min(a["parity_cnode_match"],
                              a["parity_loglik_match"]) >= 0.95 * P
                and a["parity_tsv_rows_equal"] == a["parity_rows"])) \
            and ("launches" not in a or min(a["launches"].values()) > 0)

    print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
