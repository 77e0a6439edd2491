"""One run of one cell: set-up, the measured window, the traced reading
and the check of the window's rows against the plain reference.

The program under test is hmmufotu_tpu_torch's assign CLI: its parser,
its stream (cli.assign.stream_single over pipeline.assign_stream) for
single-end reads and its batch loop (cli.assign.batch_loop) for pairs,
on a DB loaded through the program's own loaders.  The traffic file
names the CLI flags; the path follows from them as the CLI's main()
chooses it.

Program sets the program up once; Window makes one seed's read pool and
runs its warm-up and measured window; run() is the benchmark's run of
one seed, and control.py runs several seeds on one set-up.
"""

from __future__ import annotations

import gc
import json
import math
import os
import resource
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg: str):
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


class WindowClosed(Exception):
    """Raised from the rows file's flush once the window has closed."""


class Rows:
    """The TSV the CLI writes, in a file; flush() (after each batch)
    counts the batch's rows into the window while the window is open,
    and ends the stream once it has closed."""

    def __init__(self, path: str, seconds: float | None):
        self.fh = open(path, "w")
        self.seconds = seconds
        self.t0 = None
        self.pending = 0
        self.rows = 0
        self.t_last = None
        self.batches = 0

    def start(self):
        self.t0 = time.perf_counter()
        self.t_last = self.t0

    def write(self, s: str):
        self.pending += s.count("\n")
        self.fh.write(s)

    def flush(self):
        self.fh.flush()
        now = time.perf_counter()
        if self.seconds is not None and now - self.t0 > self.seconds:
            raise WindowClosed
        self.rows += self.pending
        self.pending = 0
        self.t_last = now
        self.batches += 1

    def close(self):
        self.fh.close()


def load_cell(root: str, name: str):
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    pb = os.path.join(root, "portbench")
    cfg = json.load(open(os.path.join(pb, "configs", cell["config"] + ".json")))
    traffic = json.load(open(os.path.join(pb, "traffic",
                                          cell["traffic"] + ".json")))
    checks = json.load(open(os.path.join(pb, "checks", name + ".json")))
    return bench, cell, cfg, traffic, checks


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list[dict]:
    """The metrics this cell reports: its end-to-end ones with --trace 0,
    its per-layer ones with --trace 1."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def make_traffic(traffic: dict, seed: int, n: int, codes):
    """n reads (or pairs) from the seed: [PrimarySeq], [PrimarySeq] of
    mates (empty for single-end)."""
    from hmmufotu_tpu_torch.seq import PrimarySeq
    from . import gen
    rng = np.random.default_rng(seed)
    if traffic["kind"] == "paired":
        fwd, rev = gen.simulate_pairs(codes, rng, n, traffic["read_len"],
                                      traffic["frag_mean"], traffic["frag_sd"],
                                      traffic["sub_rate"])
        return ([PrimarySeq(f"r{i}", s, "") for i, s in enumerate(fwd)],
                [PrimarySeq(f"r{i}", s, "") for i, s in enumerate(rev)])
    reads = gen.simulate_reads(codes, rng, n, traffic["read_len"],
                               traffic.get("region"), traffic["sub_rate"])
    return [PrimarySeq(f"r{i}", s, "") for i, s in enumerate(reads)], []


class Program:
    """The system under test, set up for one cell: the DB loaded through
    the program's loaders, its messages evaluated on the card, the
    placer and the aligner, as the assign CLI builds them.  msg_bf16:
    the placer stores its messages in bf16 (the check's control)."""

    def __init__(self, root, cell_name, device, t_start, msg_bf16=False):
        self.root = root
        (self.bench, self.cell, self.cfg, self.traffic,
         self.checks) = load_cell(root, cell_name)
        import torch
        if device == "cuda":
            if not torch.cuda.is_available() or \
                    torch.cuda.device_count() < self.cell["chips"]:
                log(f"needs {self.cell['chips']} CUDA card(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
                raise SystemExit(2)
        self.dev = dev = torch.device(device)
        from hmmufotu_tpu_torch.cli import assign as cli
        from hmmufotu_tpu_torch.hmm import (GLOBAL, NGCL, ProfileHMM,
                                            ViterbiAligner)
        from hmmufotu_tpu_torch.index import CSFMIndex
        from hmmufotu_tpu_torch.msa import MSA
        from hmmufotu_tpu_torch.phylo import PTUnrooted
        from . import dbcache
        self.cli = cli
        setup = self.setup = {"imports_s": time.perf_counter() - t_start}

        cache = self.cache = dbcache.DbCache(self.cfg)
        if not cache.complete():
            # in a process of its own, so that the build's peaks are not
            # this run's; its time is recorded apart from set-up's
            import subprocess
            t0 = time.perf_counter()
            subprocess.run([sys.executable, "-m", "portbench.dbcache",
                            self.cell["config"], device], cwd=root,
                           check=True)
            setup["db_build_s"] = time.perf_counter() - t0
            log(f"DB cache built in {setup['db_build_s']:.1f} s")

        # the program's load of the DB's host pieces
        t0 = time.perf_counter()
        self.msa = MSA.load(cache.msa)
        self.csfm = CSFMIndex.load(cache.csfm)
        hmm = ProfileHMM.from_hmmer_file(cache.hmm)
        self.tree = PTUnrooted.load(cache.ptu)
        setup["db_load_s"] = time.perf_counter() - t0

        # messages on the card, in place of the .ptu.npz's, then the placer
        traffic = self.traffic
        self.paired = traffic["kind"] == "paired"
        args = self.args = cli.build_parser().parse_args(
            ["db", "reads"] + (["mates"] if self.paired else [])
            + list(traffic.get("flags", [])))
        args.batch = traffic["batch"]
        t0 = time.perf_counter()
        self.tree.evaluate(dtype=np.float32, engine="torch", device=dev)
        self.tree.msg_read_dtype = np.float64     # as Database.load leaves it
        self.make_placer(msg_bf16)
        setup["evaluate_upload_s"] = time.perf_counter() - t0

        self.mode = GLOBAL if (self.paired or args.single) else NGCL
        hmm.set_sequence_mode(self.mode)
        hmm.wing_retract()
        self.aligner = ViterbiAligner(hmm, device=dev)

    def make_placer(self, msg_bf16):
        import torch
        from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
        self.placer = None
        gc.collect()
        args = self.args
        self.placer = DevicePlacer(
            self.tree, max_nseed=args.max_nseed, device=self.dev,
            opt_k=args.opt_k or None,
            msg_dtype=torch.bfloat16 if (args.msg_bf16 or msg_bf16)
            else None, site_window=None, ref_rank=args.ref_rank)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def drive(self, out, fw, rv):
        args, cli = self.args, self.cli
        if self.paired or args.chimera or args.align_only:
            return cli.batch_loop(args, self.aligner, self.csfm, self.tree,
                                  self.placer, fw, rv, self.mode, None, out,
                                  None, None, None)
        return cli.stream_single(args, self.aligner, self.csfm, self.tree,
                                 self.placer, fw, self.mode, None, out, None)

    def free(self):
        """Drop the program's state (before the reference runs)."""
        import torch
        self.placer = self.aligner = self.csfm = self.msa = None
        if self.tree is not None:
            self.tree.msg_up = self.tree.msg_down = None
        self.tree = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


class Window:
    """One seed's read pool, the CLI's strand test and warm-up, then the
    measured window: its rows, its time and, traced, its record."""

    def __init__(self, prog: Program, seed: int, seconds: float,
                 trace: bool = False, t_start: float | None = None):
        import torch
        dev, args, traffic = prog.dev, prog.args, prog.traffic
        split = self.setup = {}
        # the read pool, made before the window from --seed
        t0 = time.perf_counter()
        codes = np.load(prog.cache.inputs)["codes"]
        n_warm = traffic["warmup_batches"] * args.batch
        n_win = int(math.ceil(traffic["ceiling_rate"] * seconds))
        fwd, rev = make_traffic(traffic, seed, n_warm + n_win, codes)
        del codes
        split["read_pool_s"] = time.perf_counter() - t0

        # the CLI's strand test, then warm-up batches through the same path
        t0 = time.perf_counter()
        strand = args.strand or prog.cli.detect_strand(
            prog.aligner, prog.csfm, [r.seq for r in fwd], prog.mode,
            max(args.test, prog.cli.MIN_STRAND_TEST), None)
        if strand == 2:
            from hmmufotu_tpu_torch.alphabet import DNA
            if prog.paired:
                fwd, rev = rev, fwd
            else:
                for r in fwd:
                    r.seq = DNA.revcom(r.seq)
        self.fwd, self.rev = fwd, rev
        tmpdir = tempfile.mkdtemp(prefix="portbench-")
        rows_path = os.path.join(tmpdir, "rows.tsv")
        warm = Rows(os.devnull, None)
        warm.start()
        prog.drive(warm, fwd[:n_warm], rev[:n_warm])
        warm.close()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        split["strand_warmup_s"] = time.perf_counter() - t0

        # the window
        from . import probes
        inst = probes.Instruments(prog.root, cell_metrics(
            prog.bench, prog.cell, True) if trace else [])
        prof = None
        if trace:
            inst.install()
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            prof = profile(activities=acts)
        out = Rows(rows_path, seconds)
        win_fwd, win_rev = fwd[n_warm:], rev[n_warm:]
        self.t_host0 = time.perf_counter()
        if t_start is not None:
            # set-up: process start to the window, less the DB's build
            self.setup_s = (self.t_host0 - t_start
                            - prog.setup.get("db_build_s", 0.0))
        dry = True
        try:
            if prof is not None:
                prof.__enter__()
                with torch.profiler.record_function("portbench_window_start"):
                    pass
            out.start()
            prog.drive(out, win_fwd, win_rev)
        except WindowClosed:
            dry = False
        finally:
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if prof is not None:
                prof.__exit__(None, None, None)
        inst.undo()
        out.close()
        self.rows, self.batches, self.dry = out.rows, out.batches, dry
        self.window_s = out.t_last - out.t0
        if dry:
            log(f"the read pool of {len(win_fwd)} ran dry before "
                f"{seconds} s: the window ends at its last batch")
        log(f"window: {out.rows} rows in {out.batches} batches, "
            f"{self.window_s:.3f} s")
        self.runrec = dict(cell=prog.cell["name"], rows=out.rows,
                           window_s=self.window_s,
                           setup={**prog.setup, **split},
                           spans=dict(inst.spans.s),
                           calls=dict(inst.spans.calls), device=dev.type)
        self.breakdown = None
        self.inst = inst
        if prof is not None:
            self.runrec.update(read_profile(prof, torch, inst, self.t_host0,
                                            dev))
            self.breakdown = self.runrec.pop("breakdown", None)
        with open(rows_path) as fh:
            self.lines = [ln for ln in fh][:out.rows]
        os.remove(rows_path)
        os.rmdir(tmpdir)
        self.failed = sum(1 for ln in self.lines if "\tNULL\t" in ln)

    def metric(self, name):
        """A per-layer metric's reading of this window, or None."""
        return self.inst.read(name, self.runrec)


def run(root, cell_name, seed, seconds, trace, device, t_start) -> dict:
    """One run of the benchmark: set-up, the window, the reference's
    check of the window's rows; the result line's dict."""
    import torch
    prog = Program(root, cell_name, device, t_start)
    win = Window(prog, seed, seconds, trace, t_start)
    dev = prog.dev
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    setup = win.runrec["setup"]
    # what no stage above times: the set-up's glue between them
    setup["other_s"] = win.setup_s - sum(
        v for k, v in setup.items() if k != "db_build_s")
    log(f"set-up {win.setup_s:.3f} s (the DB's build apart): "
        + ", ".join(f"{k} {v:.3f}" for k, v in setup.items()))
    cache, traffic, bench, cell = prog.cache, prog.traffic, prog.bench, \
        prog.cell
    paired, checks = prog.paired, prog.checks
    prog.free()
    t0 = time.perf_counter()
    nums = check_rows(cache, traffic, win.lines, win.fwd, win.rev, seed, dev,
                      paired)
    log(f"reference check of {nums['rows_judged']} rows in "
        f"{time.perf_counter() - t0:.1f} s")

    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        v = None
        if m["name"] == "reads_per_s":
            v = win.rows / win.window_s if win.window_s > 0 else None
        elif m["name"] == "setup_s":
            v = win.setup_s
        elif m["name"] == "device_peak_gb":
            v = peak / 1e9 if dev.type == "cuda" else None
        elif m["name"] == "host_rss_gb":
            v = rss / 1e9
        elif trace:
            v = win.metric(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    devinfo = {"platform": "gpu" if dev.type == "cuda" else "cpu",
               "kind": torch.cuda.get_device_name(dev)
               if dev.type == "cuda" else "cpu",
               "count": 1, "memory_peak_bytes": int(peak)}
    if trace and "busy_s" in win.runrec:
        devinfo["busy_s"] = win.runrec["busy_s"]
        devinfo["window_s"] = win.runrec["trace_window_s"]
    res = {"attempted": int(win.rows), "failed": int(win.failed),
           "metrics": metrics, "device": devinfo, "setup_split": setup,
           "pool_ran_dry": win.dry}
    if win.breakdown is not None:
        res["breakdown"] = win.breakdown
    return verdict(res, nums, checks)


def verdict(res: dict, nums: dict, checks: dict) -> dict:
    """res with correct, the judged numbers not compared, and last the
    compared ones beside their limits."""
    compared = {k: {"value": nums[k], "limit": checks[k]} for k in checks}
    correct = (nums["rows_judged"] > 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in compared.values()))
    out = {"correct": bool(correct), **res,
           "judged": {k: v for k, v in nums.items() if k not in checks}}
    out["checks"] = compared
    return out


def read_profile(prof, torch, inst, t_host0, dev) -> dict:
    """The traced window's device numbers: busy and window seconds,
    the device seconds of the kernels the metrics name, the breakdown."""
    from . import probes
    out = {}
    path = os.path.join(tempfile.mkdtemp(prefix="portbench-trace-"),
                        "trace.json")
    prof.export_chrome_trace(path)
    events = probes.read_trace(path)
    os.remove(path)
    os.rmdir(os.path.dirname(path))
    if dev.type != "cuda":
        return out
    busy = probes.device_busy(events)
    ops = probes.device_ops(prof, torch)
    if busy is None:
        return out
    out["busy_s"] = busy[0] / 1e6
    out["trace_window_s"] = busy[1] / 1e6
    out["kernel_s"] = probes.kernel_seconds(events, inst.kernels)
    mark = [e for e in events if e.get("name") == "portbench_window_start"]
    t0_trace = float(mark[0]["ts"]) if mark else min(
        float(e["ts"]) for e in events if "ts" in e)
    out["breakdown"] = {"device_ops": ops,
                        "idle_gaps": probes.idle_gaps(
                            busy[2], inst.spans.log, t_host0, t0_trace)}
    return out


def check_rows(cache, traffic, lines, fwd, rev, seed, dev, paired,
               control=False, fault=None):
    """The reference's numbers over a sample of the window's rows drawn
    from the seed, the widest alignment among them.  fwd, rev: the whole
    pool, whose read r<i> is fwd[i]."""
    from .dbcache import reference_tree
    from .reference.judge import judge, parse_row
    from .reference.messages import gamma_rates_sum1
    rows = [parse_row(ln) for ln in lines]
    n = min(traffic["check_rows"], len(rows))
    if n == 0:
        return dict(rows_judged=0, q_rows=0, aln_score_err=None,
                    aln_off_pct=None, place_gap_ulps=None,
                    loglik_rel_err=None, q_place_ulps=None,
                    row_mismatch=None)
    rng = np.random.default_rng([seed, 1])
    span = [int(r["CS_end"]) - int(r["CS_start"]) if r["CS_start"] != "0"
            else -1 for r in rows]
    widest = int(np.argmax(span))
    others = [i for i in range(len(rows)) if i != widest]
    pick = sorted([widest] + rng.choice(others, n - 1,
                                        replace=False).tolist())
    sample = [rows[i] for i in pick]
    idx = [int(r["id"][1:]) for r in sample]
    reads = [(fwd[i].seq, rev[i].seq) if paired else fwd[i].seq
             for i in idx]
    model = json.load(open(cache.ref_model))
    rates = None if model["alpha"] is None else gamma_rates_sum1(
        model["alpha"], model["categories"])
    tree = reference_tree(cache, rates)
    tables = dict(np.load(cache.ref_hmm))
    return judge(sample, reads, tables, tree,
                 "global" if paired else "ngcl", dev, log, control, fault)
