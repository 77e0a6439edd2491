"""Database inspector CLI (reference: src/hmmufotu-inspect.cpp).

Loads all 4 DB artifacts, prints stats including the whole-tree
log-likelihood, and can export the tree / node annotations / node
sequences (hmmufotu-inspect.cpp:185-279).

Counterpart of hmmufotu_tpu/cli/inspect.py, on this package's modules.
"""

from __future__ import annotations

import argparse
import logging
import sys

from . import PROG_NAME, setup_logging
from ..alphabet import DNA
from ..db import Database
from ..seq import PrimarySeq, SeqWriter

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=f"{PROG_NAME}-inspect",
        description="Inspect an HmmUFOtu database")
    p.add_argument("db")
    p.add_argument("--sm", action="store_true",
                   help="show the substitution model")
    p.add_argument("--dg", action="store_true",
                   help="show the discrete-Gamma model")
    p.add_argument("-t", "--tree", default="", help="export Newick tree")
    p.add_argument("-a", "--anno", default="",
                   help="export node taxonomy annotations TSV")
    p.add_argument("-s", "--seq", default="",
                   help="export node sequences fasta")
    p.add_argument("-l", "--leaf-only", action="store_true")
    p.add_argument("-p", "--prefix", default="", help="node id prefix")
    p.add_argument("-v", action="count", default=0, dest="verbose")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(args.verbose + 1)

    db = Database.load(args.db)
    msa, csfm, hmm, ptu = db.msa, db.csfm, db.hmm, db.ptu
    print(f"MSA loaded. # of seq: {msa.num_seq} "
          f"CS length: {msa.cs_len}")
    print(f"CSFM-index loaded. Concatenated length: {csfm.concat_len} "
          f"CS length: {csfm.cs_len}")
    print(f"HMM profile read. Name: {hmm.name} Alphabet: DNA "
          f"Profile size: {hmm.K}")
    n_leaves = sum(ptu.is_leaf(u) for u in range(ptu.num_nodes))
    print(f"Phylogenetic tree loaded. Root ID: {ptu.root} "
          f"# of leaves: {n_leaves} # of nodes: {ptu.num_nodes} "
          f"# of branches: {ptu.num_branches} "
          f"# of sites: {ptu.cs_len}")
    print(f"Overall tree log-likelihood: {ptu.tree_loglik():g}")

    if args.sm and ptu.model is not None:
        ptu.model.write(sys.stdout)
    if args.dg:
        if ptu.dg is not None:
            print("Discrete Gamma Model is enabled for this tree")
            print(f"# of categories used: {ptu.dg.k} "
                  f"Shape parameter: {ptu.dg.alpha:g}")
        else:
            print("Discrete Gamma Model is not enabled")

    if args.tree:
        with open(args.tree, "w") as fh:
            fh.write(ptu.to_newick(prefix=args.prefix))
    if args.anno:
        with open(args.anno, "w") as fh:
            for u in range(ptu.num_nodes):
                fh.write(f"{args.prefix}{u}\t{ptu.anno[u]}\n")
    if args.seq:
        w = SeqWriter(args.seq)
        for u in range(ptu.num_nodes):
            if args.leaf_only and not ptu.is_leaf(u):
                continue
            w.write(PrimarySeq(f"{args.prefix}{u}",
                               DNA.decode(ptu.seqs[u]), ptu.anno[u]))
        w.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
