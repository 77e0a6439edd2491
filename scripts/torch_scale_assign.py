"""The PyTorch port's SEP placement at the gg_97 shape, placement only.

Counterpart of scripts/scale_assign.py on hmmufotu_tpu_torch.  At the
reference database's shape (149,999 nodes x 6,000 columns) the f32
message pair is 2 x 14.4 GB; this harness runs the single-card capacity
design, the window-resident placer:

  * the synthetic tree of torch_scale_eval.synth_tree,
  * the torch evaluate engine on the card restricted to the amplicon
    site window (PTUnrooted.evaluate(engine="torch", sites=...)), exact
    by per-site independence, its messages cached under --cache,
  * DevicePlacer(site_window=(s_lo, Ws)) with f32 or bf16 message
    storage,
  * 250 bp reads simulated from leaf sequences inside the window, already
    aligned (simulate_window_reads makes the same rng calls as that
    script's, so the reads are the same),
  * streamed placement batches (seed p-dist over all N nodes, estimate
    K2, joint 3-branch optimize K3, Q values) with summary-only
    downloads,
  * peak device memory, the resident DB bytes, and with --profile a
    torch.profiler window over one steady-state batch: device time of
    the top ops and the device's idle share of the window,
  * --parity P: the first P reads against the exact host SEP steps of
    pipeline.assign_read.

    python scripts/torch_scale_assign.py --leaves 75000 --length 6000 \
        --reads 20480 --batch 2048 --parity 128 --profile .bench/prof
CPU smoke:
    python scripts/torch_scale_assign.py --leaves 500 --length 1200 \
        --reads 256 --batch 128 --parity 8 --device cpu

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_scale_eval import (card_line, device_peak_gb,  # noqa: E402
                              peak_rss_gb, synth_tree)

# the names of the port's kernels in a profile (csrc/*.cu): K1, K4, K2,
# K3, K5
KERNEL_NAMES = ("viterbi_kernel", "est_kernel", "sep_kernel", "fp_kernel")


def simulate_window_reads(tree, n, s_lo, s_hi, read_len, rng):
    """[n] aligned digital reads from leaf windows inside CS columns
    [s_lo, s_hi): leaf codes (with the leaf's own gaps) + 2% point
    mutations.  Returns (wins [n, span] int8 ragged-padded, starts,
    ends, leaf_ids)."""
    leaves = np.nonzero(tree.has_seq)[0]
    starts = np.zeros(n, np.int64)
    ends = np.zeros(n, np.int64)
    rows = []
    leaf_ids = np.zeros(n, np.int64)
    for r in range(n):
        while True:
            u = int(leaves[rng.integers(len(leaves))])
            codes = tree.seqs[u, s_lo:s_hi]
            pos = np.nonzero(codes >= 0)[0]
            if len(pos) >= read_len + 2:
                break
        st = int(rng.integers(0, len(pos) - read_len + 1))
        w = pos[st:st + read_len]
        piece = codes[w].copy()
        mut = rng.random(read_len) < 0.02
        piece[mut] = rng.integers(0, 4, int(mut.sum()), dtype=np.int8)
        row = np.full(s_hi - s_lo, -2, np.int8)
        row[w] = piece
        rows.append(row)
        starts[r] = s_lo + w[0]
        ends[r] = s_lo + w[-1]
        leaf_ids[r] = u
    return np.stack(rows), starts, ends, leaf_ids


def load_tree_model(tree, model: str):
    """The bundled gg_97 substitution model of that name, else a default
    one; a distinct taxonomy per node modulo 97, so q_taxon groups."""
    from hmmufotu_tpu_torch.phylo import create_model, load_model
    sm = os.path.join(REPO, "hmmufotu_tpu_torch", "data",
                      f"gg_97_otus_{model}.sm")
    tree.model = load_model(sm) if os.path.exists(sm) \
        else create_model(model)
    tree.anno = [f"k__K;g__g{u % 97}" for u in range(tree.num_nodes)]


def site_window(length: int, span: int) -> tuple[int, int]:
    """(s_lo, Ws) of the resident site window, as the JAX scripts place
    it: a third of the way in, on a 128-column boundary."""
    s_lo = max(0, (length - span) // 3)
    s_lo -= s_lo % 128
    return s_lo, min(span, length - s_lo)


def window_messages(tree, args, s_lo, Ws, dev, res, whole=False):
    """Fill the tree's messages on [s_lo, s_lo + Ws) by the torch engine
    on dev, or from the cache file of the same tree, model and window;
    with whole=True on every column (the cache file named so)."""
    import torch
    L = args.length
    lo, hi = (0, L) if whole else (s_lo, s_lo + Ws)
    cache = ""
    if args.cache:
        os.makedirs(args.cache, exist_ok=True)
        tag = "whole" if whole else f"{s_lo}_{Ws}"
        cache = os.path.join(
            args.cache, f"torch_msgs_{args.leaves}_{L}_{args.seed}_"
            f"{args.model}_{tag}.npz")
    t0 = time.perf_counter()
    if cache and os.path.exists(cache):
        z = np.load(cache)
        if whole:
            tree.msg_up, tree.msg_down = z["up"], z["down"]
        else:
            tree.msg_up = np.zeros((tree.num_nodes, 4, L), np.float32)
            tree.msg_down = np.zeros((tree.num_nodes, 4, L), np.float32)
            tree.msg_up[:, :, lo:hi] = z["up"]
            tree.msg_down[:, :, lo:hi] = z["down"]
        del z
        res["eval_cached"] = True
    else:
        tree.evaluate(dtype=np.float32, engine="torch",
                      budget_bytes=4 << 30,
                      sites=None if whole else (lo, hi), device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        up, down = tree.msg_up[:, :, lo:hi], tree.msg_down[:, :, lo:hi]
        # the whole tree's pair is 28.8 GB at the gg_97 shape: cached only
        # where the disk holds it twice over
        if cache and shutil.disk_usage(args.cache).free \
                > 2 * (up.nbytes + down.nbytes):
            np.savez(cache, up=up, down=down)
    res["t_eval_s"] = time.perf_counter() - t0
    res["site_window"] = [int(s_lo), int(Ws)]


def db_resident_gb(placer) -> float:
    return sum(x.numel() * x.element_size() for x in placer.dt
               if hasattr(x, "element_size")) / 1e9


def device_busy(trace_path: str) -> tuple[float, float] | None:
    """(device-busy us, window us) of a chrome trace: the union of the
    card's kernel, copy and set intervals, over the span from the first
    to the last event of the trace.  None when the trace holds no device
    event."""
    opener = gzip.open if trace_path.endswith(".gz") else open
    with opener(trace_path, "rt") as fh:
        events = json.load(fh).get("traceEvents", [])
    spans, dev = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        spans.append((ts, ts + dur))
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((ts, ts + dur))
    if not dev:
        return None
    busy, end = 0.0, -np.inf
    for a, b in sorted(dev):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    window = max(b for _, b in spans) - min(a for a, _ in spans)
    return busy, window


def profile_window(fn, out_dir: str, dev) -> dict:
    """Run fn under torch.profiler (CPU, and CUDA on a card), write the
    chrome trace into out_dir, print the top ops by device time (CPU time
    on the CPU) to stderr and return them with the device's idle share of
    the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    cuda = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with profile(activities=acts) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize(dev)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)

    def dev_us(e):
        for k in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, k):
                return float(getattr(e, k))
        return 0.0

    # on a card the device's own events (kernels, copies, sets), whose
    # times the host-side ops that launched them repeat; on the CPU the
    # ops
    events = prof.key_averages()
    if cuda:
        events = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA] \
            or events
    key = dev_us if cuda else (lambda e: float(e.self_cpu_time_total))
    rows = sorted(events, key=key, reverse=True)[:16]
    top = [{"op": e.key, "us": key(e), "calls": int(e.count)}
           for e in rows]
    what = "device" if cuda else "CPU"
    print(f"profile ({what} time, self, top ops), trace {path}:",
          file=sys.stderr)
    for r in top:
        print(f"  {r['us']:12.1f} us  {r['calls']:6d}x  {r['op'][:90]}",
              file=sys.stderr)
    out = {"trace": path, "top_ops": top, "time_of": what}
    if cuda:
        # the hand-written kernels by name, wherever they rank
        out["kernels"] = {
            name: {"us": sum(dev_us(e) for e in events if name in e.key),
                   "calls": sum(int(e.count) for e in events
                                if name in e.key)}
            for name in KERNEL_NAMES}
        print(f"  kernels: {json.dumps(out['kernels'])}", file=sys.stderr)
    busy = device_busy(path) if cuda else None
    if busy is not None:
        out["device_busy_us"], out["window_us"] = busy
        out["device_idle_share"] = 1.0 - busy[0] / busy[1]
        print(f"  device busy {busy[0]:.1f} us of a {busy[1]:.1f} us "
              f"window: idle share {out['device_idle_share']:.4f}",
              file=sys.stderr)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--leaves", type=int, default=75000)
    ap.add_argument("--length", type=int, default=6000)
    ap.add_argument("--reads", type=int, default=100000)
    ap.add_argument("--read-len", type=int, default=250)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--window", type=int, default=512,
                    help="placement window W")
    ap.add_argument("--span", type=int, default=1024,
                    help="resident site-window width Ws")
    ap.add_argument("--msg-dtype", default="bf16",
                    choices=["bf16", "f32"])
    ap.add_argument("--model", default="GTR")
    ap.add_argument("--parity", type=int, default=128,
                    help="reads to cross-check vs the exact host path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-nseed", type=int, default=50)
    ap.add_argument("--cache", default="",
                    help="dir caching the evaluated message window")
    ap.add_argument("--eval-only", action="store_true",
                    help="evaluate + write the cache, exit")
    ap.add_argument("--profile", default="",
                    help="dir: torch.profiler trace of one steady-state "
                         "batch, with the top ops' device time and the "
                         "device's idle share")
    ap.add_argument("--device", default="cuda",
                    help="cuda; cpu only when asked for")
    args = ap.parse_args(argv)

    import torch
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch._cuda import resolve_device
    from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"

    rng = np.random.default_rng(args.seed)
    res = {"device": str(dev), "card": card_line(dev),
           "leaves": args.leaves, "length": args.length,
           "msg_dtype": args.msg_dtype, "batch": args.batch}

    # ---- tree + model ---------------------------------------------------
    t0 = time.perf_counter()
    tree = synth_tree(args.leaves, args.length, args.seed)
    load_tree_model(tree, args.model)
    res["n_nodes"] = tree.num_nodes
    res["t_synth_s"] = time.perf_counter() - t0

    # ---- window-restricted evaluate on the device -----------------------
    L = args.length
    s_lo, Ws = site_window(L, args.span)
    window_messages(tree, args, s_lo, Ws, dev, res)
    if args.eval_only:
        print(json.dumps({"eval_only": True, **res}))
        return 0

    # ---- reads ----------------------------------------------------------
    t0 = time.perf_counter()
    wins_full, starts, ends, leaf_ids = simulate_window_reads(
        tree, args.reads, s_lo, s_lo + Ws, args.read_len, rng)
    res["t_simreads_s"] = time.perf_counter() - t0

    # ---- placer staging -------------------------------------------------
    msg_dtype = torch.bfloat16 if args.msg_dtype == "bf16" else None
    t0 = time.perf_counter()
    placer = DevicePlacer(tree, window=args.window,
                          max_nseed=args.max_nseed, device=dev,
                          msg_dtype=msg_dtype,
                          site_window=(int(s_lo), int(Ws)))
    if cuda:
        torch.cuda.synchronize(dev)
    res["t_stage_s"] = time.perf_counter() - t0

    # pre-sliced [B, W] windows at the placer's clamped start
    W = placer.W
    sc = np.minimum(starts, placer.start_bound)
    off = (sc - s_lo).astype(np.int64)
    wins = np.full((args.reads, W), -2, np.int8)
    for r in range(args.reads):
        seg = wins_full[r, off[r]:off[r] + W]
        wins[r, :len(seg)] = seg
    ends_c = np.minimum(ends, sc + W - 1)

    def stream(lo_hi):
        # batch k's summary is downloaded after batch k+1 is enqueued;
        # a last partial batch is dropped, as the JAX script does
        lo, hi = lo_hi
        handle = None
        n_done = 0
        for b0 in range(lo, hi, args.batch):
            b1 = min(b0 + args.batch, hi)
            if b1 - b0 < args.batch:
                break
            nxt = placer.dispatch_win(
                wins[b0:b1], starts[b0:b1].astype(np.int32),
                ends_c[b0:b1].astype(np.int32))
            if handle is not None:
                handle["summary"].cpu().numpy()
                n_done += args.batch
            handle = nxt
        if handle is not None:
            handle["summary"].cpu().numpy()
            n_done += args.batch
        return n_done

    # ---- warm-up + timed stream -----------------------------------------
    t0 = time.perf_counter()
    stream((0, args.batch))
    res["t_compile_s"] = time.perf_counter() - t0

    if args.profile:
        res["profile"] = profile_window(lambda: stream((0, args.batch)),
                                        args.profile, dev)

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    n_done = stream((0, args.reads))
    if cuda:
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    res["reads_placed"] = int(n_done)
    res["t_assign_s"] = dt
    res["reads_per_s"] = n_done / dt if dt > 0 else None
    res["device_peak_gb"] = device_peak_gb(dev)
    res["device_limit_gb"] = (torch.cuda.get_device_properties(dev)
                              .total_memory / 1e9 if cuda else None)
    res["db_resident_gb"] = db_resident_gb(placer)

    # ---- parity spot-check vs exact host SEP path -----------------------
    P = min(args.parity, args.reads, args.batch)
    if P:
        Bc = min(args.batch, args.reads)
        out = placer.place_batch_win(
            wins[:Bc], starts[:Bc].astype(np.int32),
            ends_c[:Bc].astype(np.int32), summary_only=True)
        s = out["summary"]
        n_match = n_leaf = 0
        max_dll = 0.0
        t0 = time.perf_counter()
        for r in range(P):
            seq = np.full(L, -2, np.int8)
            seq[s_lo:s_lo + Ws] = wins_full[r]
            st, en = int(starts[r]), int(ends_c[r])
            # the steps of pipeline.assign_read, uniform prior
            locs = pl.get_seed(tree, seq, st, en,
                               max_nseed=args.max_nseed)
            places = pl.estimate_seq(tree, seq, locs)
            places = pl.filter_placements(places)
            places = pl.place_seq(tree, seq, places)
            pl.calc_q_values(tree, places)
            places.sort(key=lambda p: -p.q_place)
            host_best = places[0]
            dev_node = int(s[r, 0])
            if dev_node == host_best.c_node:
                n_match += 1
                max_dll = max(max_dll, abs(float(s[r, 5])
                                           - host_best.loglik))
            if dev_node == leaf_ids[r]:
                n_leaf += 1
        res["t_parity_s"] = time.perf_counter() - t0
        res["parity_reads"] = P
        res["parity_cnode_match"] = n_match
        res["parity_max_abs_dloglik"] = max_dll
        res["dev_hits_true_leaf"] = n_leaf

    res["peak_rss_gb"] = peak_rss_gb()
    print(json.dumps(res))
    ok = (res.get("parity_cnode_match", 0) >= 0.95 * P if P else True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
