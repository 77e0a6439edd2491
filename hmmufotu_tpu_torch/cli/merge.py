"""OTU-table merge CLI (reference: src/hmmufotu-merge.cpp).

Merges >=2 OTU tables aligning on OTU/sample names (reference
OTUTable::operator+=, OTUTable.cpp:211-240); optionally writes the
merged OTU tree from the database.

Host counterpart of hmmufotu_tpu/cli/merge.py on this package's own
modules; the same arguments give the same output.
"""

from __future__ import annotations

import argparse
import logging
import sys

from . import PROG_NAME, prog_header, setup_logging
from ..otu import OTUTable

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=f"{PROG_NAME}-merge",
        description="Merge two or more OTU tables")
    p.add_argument("inputs", nargs="+")
    p.add_argument("-o", dest="out", required=True)
    p.add_argument("-db", default="", help="database prefix for -t")
    p.add_argument("-t", "--tree", default="",
                   help="write merged OTU tree (requires -db)")
    p.add_argument("-p", "--prefix", default="OTU_")
    p.add_argument("-v", action="count", default=0, dest="verbose")
    return p


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    args = build_parser().parse_args(argv)
    setup_logging(args.verbose + 1)
    if len(args.inputs) < 2:
        log.error("need at least 2 OTU tables to merge")
        return 1

    merged = OTUTable()
    for path in args.inputs:
        merged += OTUTable.load_table(path)
    with open(args.out, "w") as fh:
        fh.write(prog_header([f"{PROG_NAME}-merge"] + list(argv)))
        merged.save_table(fh)
    log.info("Merged table: %d OTUs x %d samples", merged.num_otus,
             merged.num_samples)

    if args.tree:
        if not args.db:
            log.error("-t requires -db")
            return 1
        from ..db import Database
        # the topology alone: to_newick and the parent walk read no more
        tree = Database.load_topology(args.db)
        nodes = set()
        for otu_id in merged.otus:
            if otu_id.startswith(args.prefix):
                try:
                    nodes.add(int(otu_id[len(args.prefix):]))
                except ValueError:
                    pass
        ancestors = set()
        for u in nodes:
            p = u
            while p >= 0:
                ancestors.add(int(p))
                p = int(tree.parent[p]) if tree.parent[p] >= 0 else -1
        with open(args.tree, "w") as fh:
            fh.write(tree.to_newick(subset=ancestors,
                                    prefix=args.prefix))
    return 0


if __name__ == "__main__":
    sys.exit(main())
