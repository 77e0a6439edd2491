"""Read simulator CLI (reference: src/hmmufotu-sim.cpp).

Samples a branch (node + branching point), a CS region and per-site
bases from the posterior of the two branch-end messages convolved to
the branch point (rLoglik, hmmufotu-sim.cpp:391-408); gap sites are
sampled from the MSA's weighted gap fractions.

Host counterpart of hmmufotu_tpu/cli/sim.py on this package's own
modules; the same arguments give the same output.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from . import PROG_NAME, setup_logging
from ..db import Database
from ..phylo.tree import dot_product_scaled
from ..seq import PrimarySeq, SeqWriter

log = logging.getLogger(__name__)

DEFAULT_MEAN_SIZE = 500.0   # hmmufotu-sim.cpp:57
DEFAULT_SD_SIZE = 30.0
PAD_SYM = "."
GAP_SYM = "-"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=f"{PROG_NAME}-sim",
        description="Generate simulated reads from an HmmUFOtu database")
    p.add_argument("db")
    p.add_argument("out")
    p.add_argument("-N", type=int, required=True, help="number of reads")
    p.add_argument("-m", "--mate", default="", help="mate output (PE)")
    p.add_argument("-d", "--max-dist", type=float, default=np.inf)
    p.add_argument("--mean-size", type=float, default=DEFAULT_MEAN_SIZE)
    p.add_argument("--sd-size", type=float, default=DEFAULT_SD_SIZE)
    p.add_argument("--min-size", type=float, default=0.0)
    p.add_argument("--max-size", type=float, default=0.0)
    p.add_argument("-l", "--read-len", type=int, default=-1)
    p.add_argument("-R", "--region", default="",
                   help="TSV of restricted regions (name start end)")
    p.add_argument("-S", "--seed", type=int, default=0)
    p.add_argument("-p", "--prefix", default="r")
    p.add_argument("-g", "--keep-gap", action="store_true")
    p.add_argument("-v", action="count", default=0, dest="verbose")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(args.verbose + 1)
    rng = np.random.default_rng(args.seed)

    db = Database.load(args.db)
    tree, msa = db.ptu, db.msa
    cs_len = tree.cs_len
    model = tree.model
    gap_wfrac = msa.gap_wfrac()

    loci = []
    if args.region:
        with open(args.region) as fh:
            for line in fh:
                f = line.split()
                if len(f) >= 3 and not line.startswith("#"):
                    try:
                        s, e = int(f[1]), int(f[2])
                    except ValueError:
                        continue
                    if 0 <= s < e <= cs_len:
                        loci.append((s + 1, e))

    node_w = np.ones(tree.num_nodes)
    if np.isfinite(args.max_dist):
        node_w[tree.heights > args.max_dist] = 0.0
    node_w /= node_w.sum()

    seq_o = SeqWriter(args.out)
    mate_o = SeqWriter(args.mate) if args.mate else None

    n = 1
    while n <= args.N:
        u = int(rng.choice(tree.num_nodes, p=node_w))
        if tree.parent[u] < 0:
            continue
        p = int(tree.parent[u])
        v = float(tree.brlen[u])
        rc = float(rng.random())
        if tree.heights[u] + v * rc > args.max_dist:
            continue
        if not loci:
            start = int(rng.integers(0, cs_len))
            ln = float(rng.normal(args.mean_size, args.sd_size))
            ln = max(ln, args.min_size)
            if args.max_size > 0:
                ln = min(ln, args.max_size)
            end = start + int(ln)
            if end >= cs_len:
                continue
        else:
            start, end = loci[int(rng.integers(len(loci)))]
            start -= 1
            end -= 1

        # posterior base distribution at the branch point for the
        # whole window (vectorized over sites, sim.cpp:401-407)
        sl = slice(start, end + 1)
        r_loglik = (dot_product_scaled(model.Pr(v * rc),
                                       tree.up_rows(u, sl))
                    + dot_product_scaled(model.Pr(v * (1 - rc)),
                                         tree.down_rows(u, sl)))
        pr = np.exp(r_loglik - r_loglik.max(axis=0, keepdims=True))
        pr /= pr.sum(axis=0, keepdims=True)
        w = end - start + 1
        gaps = rng.random(w) <= gap_wfrac[sl]
        cum = pr.cumsum(axis=0)
        draws = (rng.random(w)[None, :] < cum).argmax(axis=0)

        bases = np.frombuffer(b"ACGT", dtype=np.uint8)[draws]
        if args.keep_gap:
            body = np.where(gaps, np.uint8(ord(GAP_SYM)), bases)
            seq = (PAD_SYM * start + body.tobytes().decode()
                   + PAD_SYM * (cs_len - 1 - end))
        else:
            seq = bases[~gaps].tobytes().decode()

        rid = f"{args.prefix}{n}"
        taxon_id = u if rc <= 0.5 else p
        taxon = tree.anno[taxon_id]
        desc = (f"branchID={u}->{p};taxonID={taxon_id};"
                f"taxonName=\"{taxon}\";branchPoint={rc:g};"
                f"csStart={start};csEnd={end};seqLen={len(seq)};")
        insert = PrimarySeq(rid, seq, desc)
        rl = args.read_len if args.read_len > 0 else len(seq)
        seq_o.write(insert.trunc(0, rl))
        if mate_o:
            mate_o.write(insert.revcom().trunc(0, rl))
        n += 1

    seq_o.close()
    if mate_o:
        mate_o.close()
    log.info("Simulated %d reads", args.N)
    return 0


if __name__ == "__main__":
    sys.exit(main())
