"""Primer annealing evaluation CLI (reference:
src/hmmufotu-anneal.cpp).

Unbanded HMM alignment of (IUPAC-degenerate) primers on either
strand, then counts tree nodes/leaves whose sequences are within a
p-dist threshold of the aligned region (:246-287).

Counterpart of hmmufotu_tpu/cli/anneal.py: the primers are aligned by this
package's ViterbiAligner on `device` (main(argv, device="cuda"),
as assign).
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from . import PROG_NAME, setup_logging
from .._cuda import resolve_device
from ..alphabet import IUPACNucl, iupac_match_matrix
from ..db import Database
from ..hmm import NGCL, ViterbiAligner
from ..seq import read_seqs

log = logging.getLogger(__name__)

ANNEAL_HEADER = ("id\tdescription\tseq\tstrand\tCS_start\tCS_end\t"
                 "CS_aln\ttotal_nodes\ttotal_leaves\thit_nodes\t"
                 "hit_leaves\tnode_frac\tleaf_frac")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=f"{PROG_NAME}-anneal",
        description="Evaluate primer annealing sites against a "
                    "database")
    p.add_argument("db")
    p.add_argument("primers", help="primer fasta (IUPAC codes allowed)")
    p.add_argument("-o", dest="out", default="-")
    p.add_argument("-i", "--identity", type=float, default=0.9)
    p.add_argument("-s", "--strand", type=int, default=3,
                   choices=[1, 2, 3])
    p.add_argument("-v", action="count", default=0, dest="verbose")
    return p


def degenerate_p_dist(match_mat: np.ndarray, aln: str,
                      node_seq: np.ndarray, start: int,
                      end: int) -> float:
    """p-dist with IUPAC degenerate matching over the full window
    (reference SeqUtils::pDist(string, DigitalSeq), SeqUtils.cpp:76-85)."""
    win = np.frombuffer(aln[start:end + 1].encode(), dtype=np.uint8)
    bases = node_seq[start:end + 1]
    ok = bases >= 0
    m = np.zeros(len(win), dtype=bool)
    m[ok] = match_mat[win[ok], bases[ok]]
    return float((~m).sum()) / (end - start + 1)


def main(argv=None, device="cuda") -> int:
    """Run the primer evaluation; device="cuda" (default) or "cpu"."""
    args = build_parser().parse_args(argv)
    setup_logging(args.verbose + 1)
    dev = resolve_device(device)

    db = Database.load(args.db)
    tree, hmm = db.ptu, db.hmm
    hmm.set_sequence_mode(NGCL)
    hmm.wing_retract()
    aligner = ViterbiAligner(hmm, device=dev)
    max_dist = 1 - args.identity
    match_mat = iupac_match_matrix()

    n_nodes = tree.num_nodes
    leaves = np.array([tree.is_leaf(u) for u in range(n_nodes)])
    n_leaves = int(leaves.sum())

    out = sys.stdout if args.out == "-" else open(args.out, "w")
    out.write(ANNEAL_HEADER + "\n")
    for rec in read_seqs(args.primers, abc=IUPACNucl):
        cands = []
        if args.strand & 1:
            cands.append(("+", rec.seq))
        if args.strand & 2:
            cands.append(("-", IUPACNucl.revcom(rec.seq)))
        alns = aligner.align_batch([s for _, s in cands])
        best = min(range(len(alns)), key=lambda i: alns[i].cost)
        strand = cands[best][0]
        aln = alns[best]
        hit_nodes = hit_leaves = 0
        for u in range(n_nodes):
            pd = degenerate_p_dist(match_mat, aln.align, tree.seqs[u],
                                   aln.cs_start - 1, aln.cs_end - 1)
            if pd <= max_dist:
                hit_nodes += 1
                if leaves[u]:
                    hit_leaves += 1
        region = aln.align[aln.cs_start - 1:aln.cs_end]
        out.write(f"{rec.id}\t{rec.desc}\t{rec.seq}\t{strand}\t"
                  f"{aln.cs_start}\t{aln.cs_end}\t{region}\t"
                  f"{n_nodes}\t{n_leaves}\t{hit_nodes}\t{hit_leaves}\t"
                  f"{hit_nodes / n_nodes:g}\t"
                  f"{hit_leaves / n_leaves:g}\n")
    if out is not sys.stdout:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
