"""`assign --num-processes N` at size through the PyTorch port's CLIs:
N processes a run, on one card or one card each, against one process.

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
             (torch_scale_e2e.simulate_pairs), as two FASTA files; on a
             card the kernels are built here, before any CLI starts;
  2. build   the build CLI (-s GTR --msg-dtype f32 --eval-engine torch);
  3. runs    single-end reads at each N of --processes, then the pairs at
             each N of --pair-processes, N = 1 first: N assign children
             started at once, each `main(argv + --num-processes N
             --process-id i --coordinator 127.0.0.1:<free port>)` with -a
             (its --align-out file gets the suffix .p<i> at N > 1); with
             --card-per-process child i sees card i alone
             (CUDA_VISIBLE_DEVICES=i), else they share the card.  With
             --mesh, one more single-end run: one process over every
             card (`assign --mesh`).  A child that exits non-zero while
             others run stops the run after GRACE_S seconds;
  4. gates   every child exits 0; process 0's gathered TSV has data rows
             byte-equal to the N = 1 run's (the --mesh run's too); the
             --align-out files present; process 0 of each N = 1 run
             holds its first --parity placements against the exact host
             path (torch_scale_cli's parity; at N > 1 the rows are held
             byte-equal to those, and parity is 0).  Any failure: rc 1.
             Nothing falls back to the CPU or to one process;
  5. guards  an N is skipped, with its numbers in `skipped`, when N x
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
written (abort_after_rows).  Per N: reads_per_s_stream (reads over the
slowest process's stream_s + gather_s: at N = 1 the stream writes the
TSV itself, at N > 1 process 0 writes it in gather_s, so every N is
clocked over the same work), reads_per_s_wall (reads over the seconds
from the launch to the last process's return from the CLI; process 0's
parity after it is not counted), each one's efficiency rate(N) / (N x
rate(1)), rows_equal and the --align-out files.  Every assign child
runs with -a, HMMUFOTU_TIMING=1 and torch_scale_cli's stage wrappers.  One JSON line, the
last the script prints, with every number, the card line, nproc,
`free -g`'s total and the card count; --progress FILE gets the numbers
so far after each run.

One H100, 65,535 nodes (two processes at 149,999 nodes do not fit one
card):
    python scripts/torch_scale_procs.py --leaves 32768 --length 6000 \\
        --reads 400000 --pairs 50000 --processes 1,2,3 \\
        --progress out/procs.json
Four H100s, the gg_97 shape, one process a card, and --mesh:
    python scripts/torch_scale_procs.py --leaves 75000 --length 6000 \\
        --reads 100000 --pairs 20000 --processes 1,2,4 \\
        --card-per-process --mesh --progress out/procs4.json
CPU smoke:
    python scripts/torch_scale_procs.py --leaves 64 --length 600 \\
        --reads 256 --pairs 64 --processes 1,2 --eval-engine numpy \\
        --device cpu --work /tmp/procs

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


def child_env(i: int, card_per_process: bool, mesh: bool) -> dict | None:
    """Child i's additions to the environment: with --card-per-process
    it sees card i alone, but a --mesh run sees every card."""
    if card_per_process and not mesh:
        return {"CUDA_VISIBLE_DEVICES": str(i)}
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


def rows_compare(path: str, ref: str) -> dict:
    """Data rows of two TSVs, byte for byte, in order."""
    n = n_ref = differ = 0
    a, b = data_rows(path), data_rows(ref)
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


def run_n(args, tag: str, n: int, inputs: list[str], prefix: str,
          base: dict | None, extra=()) -> dict:
    """N assign children at once on `inputs`; the run's per-process and
    per-N numbers and its gates (against base, the N = 1 run)."""
    d = args.work
    tsv = os.path.join(d, f"{tag}.tsv")
    aln = os.path.join(d, f"{tag}.aln.fa")
    port = free_port()
    argv = [prefix, *inputs, "-o", tsv, "-a", aln, *extra]
    cuda = args.device != "cpu"
    children, errs, envs = [], [], []
    launched_at = time.time()
    for i in range(n):
        env = child_env(i, args.card_per_process and cuda,
                        "--mesh" in extra)
        envs.append(env)
        errs.append(os.path.join(d, f"{tag}.p{i}.stderr"))
        with open(errs[-1], "w") as err:
            children.append(start_child(
                "assign", argv + ["--num-processes", str(n),
                                  "--process-id", str(i), "--coordinator",
                                  f"127.0.0.1:{port}"],
                args, tsv, parity=args.parity if base is None and i == 0
                else 0, kernels=cuda, env=env, stderr=err))
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
        procs.append(p)
    reads = args.pairs if tag.startswith("pe") else args.reads
    out = {"run": tag, "procs": procs, "fails": []}
    fails = out["fails"]
    for p in procs:
        if p["rc"] != 0 or p["exit"] != 0:
            fails.append(f"{tag} process {p['process_id']} rc {p['rc']} "
                         f"exit {p['exit']}")
        if cuda and p["rc"] == 0 and min(p["launches"].values()) <= 0:
            fails.append(f"{tag} process {p['process_id']} launches "
                         f"{p['launches']}")
    if fails:
        return out
    out.update(rates(n, reads, procs, launched_at, base))
    out["last_exit_s"] = max(p["wall_s"] for p in procs)
    out["cpu_s"] = sum(p["cpu_s"] for p in procs)
    names = [aln] if n == 1 else [f"{aln}.p{i}" for i in range(n)]
    out["align_out"] = {os.path.basename(f): os.path.exists(f)
                        for f in names}
    out["align_out_bytes"] = sum(os.path.getsize(f) for f in names
                                 if os.path.exists(f))
    for f in names:
        if os.path.exists(f):
            os.remove(f)
    if not all(out["align_out"].values()) or os.path.exists(aln) and n > 1:
        fails.append(f"{tag} --align-out files {out['align_out']}")
    if base is None:
        out["tsv"] = tsv
        out["rows"] = sum(1 for _ in data_rows(tsv))
        if args.parity and not parity_ok(procs[0]):
            fails.append(f"{tag} parity")
    else:
        out.update(rows_compare(tsv, base["tsv"]))
        if not out["rows_equal"] or out["rows"] != out["rows_ref"]:
            fails.append(f"{tag} rows differ from one process: "
                         f"{out['rows_differ']} of {out['rows_ref']}")
    return out


def brief(r: dict) -> dict:
    """A run without its per-process detail, for the log."""
    keep = {k: v for k, v in r.items() if k != "procs"}
    keep["procs"] = [{k: p.get(k) for k in (
        "rc", "exit", "wall_s", "cpu_s", "stream_cpu_s", "peak_rss_gb",
        "device_peak_gb", "cards_seen", "clocks", "stream_stages_s",
        "launches", "kernel_ms", "aborted", "abort_after_rows")}
        for p in r["procs"]]
    return keep


# ---------------------------------------------------------------------------

def parse_counts(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x] if text else []


def write_pairs(d: str, fwd, rev) -> list[str]:
    paths = [os.path.join(d, "pairs_1.fasta"), os.path.join(d,
                                                            "pairs_2.fasta")]
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
    ap.add_argument("--parity", type=int, default=128,
                    help="reads of process 0 of each N = 1 run held "
                         "against the host path")
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
    se_ns, pe_ns = parse_counts(args.processes), \
        parse_counts(args.pair_processes)
    if not se_ns:
        ap.error("--processes names no N")
    for ns in (se_ns, pe_ns):
        if ns and (ns[0] != 1 or sorted(set(ns)) != ns):
            ap.error("process counts rise from 1: " + ",".join(map(str, ns)))

    from hmmufotu_tpu_torch._cuda import resolve_device
    dev = resolve_device(args.device)
    cards = card_count(dev)
    if args.card_per_process and max(se_ns + pe_ns) > cards:
        ap.error(f"--card-per-process needs {max(se_ns + pe_ns)} cards; "
                 f"{cards} seen")
    n_nodes = 2 * args.leaves - 1
    cuts = ([("nodes", f"{GG97_NODES:,} nodes", f"{n_nodes:,} nodes")]
            if n_nodes < GG97_NODES else [])
    cuts += [("reads", CONFIG5_READS, f"{args.reads:,} reads"
              + (f", {args.pairs:,} pairs" if pe_ns else "")),
             ("hosts", "N hosts (BASELINE configs #4-#5)",
              f"processes of one host, {max(se_ns + pe_ns)} at most")]
    why = [w for w in [args.why] if w] + [
        "every run loads the whole DB in each process and fits one chip "
        "call with the build", "the port's --num-processes joins "
        "processes over gloo at a coordinator address, the same on one "
        "host or several"]
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
    se = write_fasta(os.path.join(d, "reads.fasta"), simulate_reads(
        tree, np.random.default_rng(READS_SEED), args.reads,
        region=(r0, r0 + Wr)))
    pe = []
    if pe_ns:
        fwd, rev, _, _ = simulate_pairs(
            tree, args.pairs, r0, r0 + Wr, READ_LEN,
            np.random.default_rng(PAIRS_SEED), *FRAGMENT)
        pe = write_pairs(d, fwd, rev)
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

    # ---- 3-5. the runs ----------------------------------------------------
    shared = dev.type == "cuda" and not args.card_per_process
    free_gb = res["free_total_gb"]
    for mode, ns, inputs in (("se", se_ns, [se]), ("pe", pe_ns, pe)):
        res[mode] = {}
        base = None
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
            r = run_n(args, f"{mode}_n{n}", n, inputs, prefix, base)
            res[mode][str(n)] = r
            res["fails"] += r["fails"]
            log(f"{mode} N={n}: " + json.dumps(brief(r)))
            progress()
            if base is None:
                if r["fails"]:
                    break
                base = r
        if mode == "se" and args.mesh and base is not None:
            r = run_n(args, "se_mesh", 1, inputs, prefix, base,
                      extra=["--mesh"])
            seen = [p.get("cards_seen") for p in r["procs"]]
            if seen != [cards]:
                r["fails"].append(f"se_mesh saw {seen} of {cards} cards")
            res["mesh"] = r
            res["fails"] += r["fails"]
            log("se --mesh: " + json.dumps(brief(r)))
            progress()
    # every abort seen, also of a run whose gates failed for it
    res["aborts"] = [
        {"run": r["run"], "process_id": p["process_id"], "exit": p["exit"],
         "after_rows": p["abort_after_rows"], "lines": p["abort_lines"]}
        for r in [r for m in ("se", "pe") for r in res[m].values()]
        + ([res["mesh"]] if "mesh" in res else [])
        for p in r["procs"] if p["aborted"] or p["abort_after_rows"]]
    progress()
    print(json.dumps(res))
    return 1 if res["fails"] else 0


if __name__ == "__main__":
    sys.exit(main())
