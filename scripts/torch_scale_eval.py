"""The PyTorch port's tree evaluation at the gg_97 shape.

Counterpart of scripts/scale_eval.py on hmmufotu_tpu_torch: builds the same
synthetic complete binary tree directly as PTUnrooted arrays (synth_tree
makes the same numpy rng calls in the same order, so its arrays equal that
script's bit for bit), runs the blocked level sweep of
PTUnrooted.evaluate with the torch engine on the card (or the numpy f64
engine), and prints one JSON line with the wall time, the peak host RSS
and the peak device memory.  At --leaves 75000 --length 6000 this is the
shape of the reference gg_97 database (149,999 nodes x 6,000 columns).

    python scripts/torch_scale_eval.py --leaves 75000 --length 6000 \
        --dtype f32 --engine torch --dgamma 4
CPU smoke (the torch engine on the CPU only when asked for):
    python scripts/torch_scale_eval.py --leaves 200 --length 600 \
        --dgamma 4 --device cpu

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def synth_tree(n_leaves: int, length: int, seed: int = 0,
               gap_frac: float = 0.1):
    """Complete binary tree: internals 0..n-2 (root 0), leaves
    n-1..2n-2, parent[i] = (i-1)//2; random leaf seqs with gaps."""
    from hmmufotu_tpu_torch.phylo import PTUnrooted
    rng = np.random.default_rng(seed)
    N = 2 * n_leaves - 1
    t = PTUnrooted()
    t.cs_len = length
    t.root = 0
    t.parent = np.arange(-1, N - 1) // 2
    t.parent[0] = -1
    t.brlen = rng.uniform(0.01, 0.1, N)
    t.brlen[0] = 0.0
    t.names = [f"n{i}" for i in range(N)]
    t.anno = [""] * N
    t.anno_dist = np.zeros(N)
    t.heights = np.zeros(N)
    t.msa_id = np.full(N, -1, dtype=np.int64)
    t.seqs = np.full((N, length), -128, dtype=np.int8)
    t.has_seq = np.zeros(N, dtype=bool)
    leaves = np.arange(n_leaves - 1, N)
    codes = rng.integers(0, 4, (n_leaves, length), dtype=np.int8)
    codes[rng.random((n_leaves, length)) < gap_frac] = -2  # GAP_BASE
    t.seqs[leaves] = codes
    t.has_seq[leaves] = True
    return t


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


def peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def device_peak_gb(device) -> float | None:
    """Peak device memory since the last reset, None on the CPU."""
    import torch
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 1e9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--leaves", type=int, default=15000)
    ap.add_argument("--length", type=int, default=1200)
    ap.add_argument("--dtype", default="f32",
                    choices=["f64", "f32", "f16"])
    ap.add_argument("--model", default="JC69")
    ap.add_argument("--dgamma", type=int, default=0,
                    help="discrete-Gamma categories (0 = off)")
    ap.add_argument("--budget-gb", type=float, default=2.0,
                    help="working-set budget for the blocked sweep")
    ap.add_argument("--engine", default="torch",
                    choices=["numpy", "torch"])
    ap.add_argument("--device", default="cuda",
                    help="device of the torch engine (cuda; cpu only "
                         "when asked for)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--place", action="store_true",
                    help="also run a host placement smoke on the result")
    ap.add_argument("--ref-ptu", default="",
                    help="also save/load the evaluated tree through the "
                         "reference binary .ptu format at this path "
                         "(~58 GB at the gg_97 shape)")
    args = ap.parse_args(argv)

    import torch
    from hmmufotu_tpu_torch._cuda import resolve_device
    from hmmufotu_tpu_torch.phylo import (DiscreteGammaModel, PTLoc,
                                          create_model)
    dev = resolve_device(args.device)
    card = card_line(dev)

    dtype = {"f64": np.float64, "f32": np.float32,
             "f16": np.float16}[args.dtype]
    t0 = time.perf_counter()
    tree = synth_tree(args.leaves, args.length, args.seed)
    tree.model = create_model(args.model)
    if args.dgamma:
        tree.dg = DiscreteGammaModel(0.5, args.dgamma)
    t_synth = time.perf_counter() - t0

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tree.evaluate(dtype=dtype, engine=args.engine,
                  budget_bytes=int(args.budget_gb * (1 << 30)), device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_eval = time.perf_counter() - t0
    dev_peak = device_peak_gb(dev)

    ll = tree.tree_loglik()
    n_int = tree.num_nodes - int(tree.has_seq.sum())
    # internal up-messages must be finite (P(t) > 0 for every model)
    sample = np.arange(0, n_int, max(1, n_int // 64))
    ok = bool(np.isfinite(tree.msg_up[sample]).all()
              and np.isfinite(tree.msg_down[sample + 1]).all())

    place_ok = None
    if args.place:
        # host-exact placement smoke against the stored messages
        rng = np.random.default_rng(args.seed + 1)
        u = tree.num_nodes - 1  # a leaf
        seq = tree.seqs[u].copy()
        mut = rng.random(args.length) < 0.02
        seq[mut] = rng.integers(0, 4, int(mut.sum()))
        loc = PTLoc(0, args.length - 1, u, 0.02)
        est = tree.estimate_seq(seq, loc)
        pl = tree.place_seq(seq, est)
        place_ok = bool(np.isfinite(pl.loglik))

    ref_ptu = None
    if args.ref_ptu:
        from hmmufotu_tpu_torch.io.reference_format import (
            load_reference_ptu, save_reference_ptu)
        t0 = time.perf_counter()
        save_reference_ptu(tree, args.ref_ptu)
        t_save = time.perf_counter() - t0
        size_gb = os.path.getsize(args.ref_ptu) / 1e9
        t0 = time.perf_counter()
        tree2 = load_reference_ptu(args.ref_ptu)
        t_load = time.perf_counter() - t0
        sample2 = sample[:8]
        round_ok = bool(
            tree2.num_nodes == tree.num_nodes
            and np.allclose(
                np.asarray(tree2.msg_up[sample2], np.float32),
                np.asarray(tree.msg_up[sample2], np.float32),
                rtol=1e-5, atol=1e-5, equal_nan=True)
            and abs(tree2.tree_loglik() - ll) / abs(ll) < 1e-5)
        ref_ptu = {"save_s": t_save, "load_s": t_load, "size_gb": size_gb,
                   "roundtrip_ok": round_ok}
        os.unlink(args.ref_ptu)
        del tree2

    print(json.dumps({
        "n_nodes": tree.num_nodes, "cs_len": args.length,
        "dtype": args.dtype, "dgamma": args.dgamma,
        "engine": args.engine, "device": str(dev),
        "t_synth_s": t_synth, "t_eval_s": t_eval,
        "tree_loglik": ll, "finite_ok": ok, "place_ok": place_ok,
        "ref_ptu": ref_ptu,
        "peak_rss_gb": peak_rss_gb(), "device_peak_gb": dev_peak,
        "budget_gb": args.budget_gb, "card": card,
    }))
    return 0 if ok and np.isfinite(ll) else 1


if __name__ == "__main__":
    sys.exit(main())
