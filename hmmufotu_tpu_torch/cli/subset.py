"""OTU-table rarefaction CLI (reference: src/hmmufotu-subset.cpp).

Host counterpart of hmmufotu_tpu/cli/subset.py on this package's own
modules; the same arguments give the same output.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from . import PROG_NAME, prog_header, setup_logging
from ..otu import OTUTable

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=f"{PROG_NAME}-subset",
        description="Subset (rarefy) an OTU table")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-n", dest="min_read", type=int, required=True,
                   help="reads to subset each sample to")
    p.add_argument("-m", "--method", default="uniform",
                   choices=["uniform", "multinomial"])
    p.add_argument("-S", "--seed", type=int, default=None)
    p.add_argument("--prune-samples", type=int, default=0)
    p.add_argument("--prune-otus", action="store_true")
    p.add_argument("-v", action="count", default=0, dest="verbose")
    return p


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    args = build_parser().parse_args(argv)
    setup_logging(args.verbose + 1)
    rng = np.random.default_rng(args.seed)

    table = OTUTable.load_table(args.input)
    table.prune_samples(max(args.min_read, args.prune_samples))
    if args.method == "uniform":
        table.subset_uniform(args.min_read, rng)
    else:
        table.subset_multinom(args.min_read, rng)
    if args.prune_otus:
        table.prune_otus(0)
    with open(args.output, "w") as fh:
        fh.write(prog_header([f"{PROG_NAME}-subset"] + list(argv)))
        table.save_table(fh)
    log.info("Subset table written: %d OTUs x %d samples",
             table.num_otus, table.num_samples)
    return 0


if __name__ == "__main__":
    sys.exit(main())
