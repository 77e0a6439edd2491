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

    python scripts/torch_scale_e2e.py --leaves 75000 --length 6000 \
        --reads 20480 --batch 2048 --repeat 3 [--msg-dtype bf16] \
        [--whole-tree]
CPU smoke:
    python scripts/torch_scale_e2e.py --leaves 300 --length 1200 \
        --reads 64 --batch 32 --parity 16 --repeat 2 --device cpu \
        [--whole-tree]

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


def host_agreement(pl, tree, alns, best, rows, W, args, log_as):
    """The device's best placements of `rows` against the exact host SEP
    path (pipeline.assign_read) on the same alignments: the counts of the
    module docstring's three rules, and the largest loglik gap."""
    n_exact = n_match = n_ll = n_both = n_trunc = n_trunc_mism = 0
    n_trunc_ll = 0
    max_dll = 0.0
    for r in rows:
        if best[r] is None or not alns[r].is_valid():
            continue
        seq = pl.aln_to_digital(tree, alns[r])
        host = pl.assign_read(tree, alns[r], seq, max_nseed=args.max_nseed)
        if host is None:
            continue
        n_both += 1
        span = alns[r].cs_end - alns[r].cs_start + 1
        trunc = span > W       # the device clamps the region to W cols
        n_trunc += int(trunc)
        ulp = abs(host.loglik) * 2.0 ** -23
        dll = abs(host.loglik - best[r].loglik)
        max_dll = max(max_dll, dll)
        n_ll += int(dll <= 8 * ulp)
        n_trunc_ll += int(trunc and dll <= 8 * ulp)
        if dll > 8 * ulp:
            log(f"{log_as} loglik apart r{r}: dev {best[r].loglik:.1f} "
                f"host {host.loglik:.1f} span {span}"
                + (" TRUNCATED" if trunc else ""))
        if best[r].c_node == host.c_node:
            n_exact += 1
            n_match += 1
        else:
            # the synthetic tree's random leaves make window logliks
            # large; candidates within a few f32 ulps of each other flip
            # between the device's and the host's summation orders
            if host.loglik - best[r].loglik <= 8 * ulp:
                n_match += 1
            else:
                n_trunc_mism += int(trunc)
                log(f"{log_as} mismatch r{r}: dev {best[r].c_node} "
                    f"(ll {best[r].loglik:.1f}) host {host.c_node} "
                    f"(ll {host.loglik:.1f}) span {span}"
                    + (" TRUNCATED" if trunc else ""))
    return {"reads": int(n_both), "cnode_exact": int(n_exact),
            "cnode_match": int(n_match), "loglik_match": int(n_ll),
            "max_abs_dloglik": float(max_dll),
            "span_gt_W": int(n_trunc), "mism_span_gt_W": int(n_trunc_mism),
            "loglik_match_span_gt_W": int(n_trunc_ll)}


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
    args = ap.parse_args(argv)

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
           "whole_tree": args.whole_tree}

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
    wins_full, _, _, leaf_ids = simulate_window_reads(
        tree, args.reads, s_lo, s_lo + Ws, args.read_len, rng)
    reads = ["".join("ACGT"[c] for c in row[row >= 0]) for row in wins_full]
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
