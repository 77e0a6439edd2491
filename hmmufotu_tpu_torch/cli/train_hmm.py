"""Profile-HMM trainer CLI (reference: src/hmmufotu-train-hmm.cpp).

Trains just the HMM profile from an MSA + Dirichlet prior and writes
the HMMER3/f text file.

Counterpart of hmmufotu_tpu/cli/train_hmm.py, on this package's modules.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from . import PROG_NAME, setup_logging
from ..hmm import ProfileHMM
from ..mathx.dirichlet import HmmPrior
from ..msa import MSA
from .build import DEFAULT_SYMFRAC, default_dm_file

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=f"{PROG_NAME}-train-hmm",
        description="Train a Banded-HMM profile from an MSA")
    p.add_argument("msa_file")
    p.add_argument("-o", dest="out", required=True)
    p.add_argument("-n", dest="name", default="")
    p.add_argument("-f", "--symfrac", type=float,
                   default=DEFAULT_SYMFRAC)
    p.add_argument("-dm", dest="dm_file", default="")
    p.add_argument("-v", action="count", default=0, dest="verbose")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(args.verbose + 1)

    msa = MSA.load_fasta(args.msa_file)
    msa.prune()
    prior = HmmPrior.load(args.dm_file or default_dm_file())
    name = args.name or os.path.basename(args.msa_file).rsplit(".", 1)[0]
    hmm = ProfileHMM.build(msa, args.symfrac, prior, name=name)
    log.info("HMM profile trained: K=%d effN=%.2f", hmm.K, hmm.eff_n)
    hmm.to_hmmer_file(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
