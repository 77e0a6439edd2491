"""OTU-table normalization CLI (reference: src/hmmufotu-norm.cpp).

Host counterpart of hmmufotu_tpu/cli/norm.py on this package's own
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
        prog=f"{PROG_NAME}-norm",
        description="Normalize an OTU table to a constant sum per "
                    "sample")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-Z", dest="const", type=float, default=0.0,
                   help="normalization constant; 0 = max sample sum; "
                        "1 = relative abundance")
    p.add_argument("-v", action="count", default=0, dest="verbose")
    return p


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    args = build_parser().parse_args(argv)
    setup_logging(args.verbose + 1)
    table = OTUTable.load_table(args.input)
    table.normalize_const(args.const)
    with open(args.output, "w") as fh:
        fh.write(prog_header([f"{PROG_NAME}-norm"] + list(argv)))
        table.save_table(fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
