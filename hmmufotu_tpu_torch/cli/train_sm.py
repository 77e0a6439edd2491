"""DNA substitution model trainer CLI (reference:
src/hmmufotu-train-sm.cpp).

Builds a PTU from an MSA + tree, extracts Goldman 2-seq / Gojobori
3-seq transition counts from tips, and trains the chosen model type
(:220-236).

Counterpart of hmmufotu_tpu/cli/train_sm.py, on this package's modules.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from . import PROG_NAME, setup_logging
from ..msa import MSA
from ..phylo import PTUnrooted, create_model, parse_newick, save_model

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=f"{PROG_NAME}-train-sm",
        description="Train a DNA substitution model from an MSA and "
                    "tree")
    p.add_argument("msa_file")
    p.add_argument("tree_file")
    p.add_argument("-o", dest="out", required=True)
    p.add_argument("-s", "--sub-model", dest="sm_type", default="GTR",
                   choices=["GTR", "TN93", "HKY85", "F81", "K80",
                            "JC69"])
    p.add_argument("-m", "--method", default="Gojobori",
                   choices=["Gojobori", "Goldman"])
    p.add_argument("-S", "--seed", type=int, default=0)
    p.add_argument("-v", action="count", default=0, dest="verbose")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(args.verbose + 1)

    msa = MSA.load_fasta(args.msa_file)
    msa.prune()
    with open(args.tree_file) as fh:
        tree = PTUnrooted.from_newick(parse_newick(fh.read()))
    n = tree.load_msa(msa)
    log.info("Tree with %d nodes; %d leaf seqs loaded", tree.num_nodes,
             n)

    rng = np.random.default_rng(args.seed)
    data = tree.get_model_training_set(args.method, rng)
    freq = tree.get_model_freq_est()
    log.info("Collected %d transition matrices (%s method)", len(data),
             args.method)

    model = create_model(args.sm_type)
    model.train(data, freq)
    save_model(model, args.out)
    log.info("Trained %s model written to %s", args.sm_type, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
