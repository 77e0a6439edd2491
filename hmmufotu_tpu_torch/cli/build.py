"""Database builder CLI (reference: src/hmmufotu-build.cpp).

Builds the 4-artifact DB (<prefix>.msa.npz/.csfm.npz/.hmm/.ptu.npz)
from an MSA fasta + Newick tree: MSA prune -> CSFM index -> HMM train
-> PTU construct/annotate -> likelihood evaluation (single up+down
sweep instead of the reference's N rerooted sweeps,
hmmufotu-build.cpp:455-459) -> optional discrete-Gamma shape fit ->
ancestral inference -> save.  The likelihood sweep is the numpy f64
engine by default; --eval-engine torch runs it as f32 tensor ops on the
device (phylo/tree.py evaluate).
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import sys

import numpy as np

from . import PROG_NAME, PROG_VERSION, setup_logging
from ..db import Database
from ..hmm import ProfileHMM
from ..index import CSFMIndex
from ..mathx.dirichlet import HmmPrior
from ..msa import MSA
from ..phylo import (DiscreteGammaModel, PTUnrooted, create_model,
                     load_model, parse_newick)
from ..phylo.tree import DEFAULT_ROOT_NAME

log = logging.getLogger(__name__)

DEFAULT_SYMFRAC = 0.5       # hmmufotu-build.cpp:55
DEFAULT_SM_TYPE = "GTR"
DEFAULT_DG_CATEGORY = 4
FIXTURE_DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def default_dm_file() -> str:
    return os.path.join(FIXTURE_DATA, "gg_97_otus.dm")


def default_sm_file(sm_type: str) -> str:
    return os.path.join(FIXTURE_DATA, f"gg_97_otus_{sm_type}.sm")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=f"{PROG_NAME}-build",
        description="Build an HmmUFOtu database from reference MSA and "
                    "phylogenetic tree files")
    p.add_argument("msa_file")
    p.add_argument("tree_file")
    p.add_argument("-n", dest="db_name", default="",
                   help="database name (prefix)")
    p.add_argument("-f", "--symfrac", type=float, default=DEFAULT_SYMFRAC)
    p.add_argument("-a", "--anno", default="",
                   help="tab-delimited taxonomy annotation file")
    p.add_argument("-r", "--root", default=DEFAULT_ROOT_NAME)
    p.add_argument("-dm", dest="dm_file", default="")
    p.add_argument("-s", "--sub-model", dest="sm_type",
                   default=DEFAULT_SM_TYPE,
                   choices=["GTR", "TN93", "HKY85", "F81", "K80", "JC69"])
    p.add_argument("-sm", dest="sm_file", default="")
    p.add_argument("-V", "--var", action="store_true",
                   help="enable discrete-Gamma rate variation")
    p.add_argument("-k", dest="dg_k", type=int, default=DEFAULT_DG_CATEGORY)
    p.add_argument("--no-hmm", action="store_true")
    p.add_argument("--msg-dtype", default="f64",
                   choices=["f64", "f32", "f16"],
                   help="in-memory storage dtype of the per-edge message "
                        "tensors during evaluation (use f32 at reference "
                        "gg_97 scale; the .ptu file stores f32 "
                        "regardless). f16 is rejected on large trees: "
                        "per-site message magnitudes grow ~linearly with "
                        "leaf count and overflow float16 near the root")
    p.add_argument("--eval-engine", default="numpy",
                   choices=["numpy", "torch"],
                   help="likelihood sweep engine: numpy = f64 "
                        "reference-exact; torch = blocked f32 tensor ops "
                        "on the device, for gg_97-scale trees")
    p.add_argument("-v", action="count", default=0, dest="verbose")
    return p


def main(argv=None, device="cuda") -> int:
    """Build and save a DB; ``device`` ("cuda" by default, or "cpu")
    runs the torch evaluate engine and nothing else."""
    args = build_parser().parse_args(argv)
    setup_logging(args.verbose + 1)
    db_name = args.db_name or os.path.basename(args.msa_file).rsplit(
        ".", 1)[0]
    db = build_database(args, db_name, device)
    if db is None:
        return 1
    db.save(db_name)
    log.info("Database saved with prefix '%s'", db_name)
    return 0


def build_database(args, db_name: str, device="cuda") -> Database | None:
    """The four DB artifacts in memory, from parsed build arguments;
    None (after logging why) when the inputs are inconsistent.
    ``device`` is that of the torch evaluate engine."""
    msa = MSA.load_fasta(args.msa_file, name=db_name)
    msa.prune()
    log.info("MSA database created for %d X %d aligned sequences",
             msa.num_seq, msa.cs_len)

    csfm = CSFMIndex.build(msa)
    log.info("CSFM index built")

    dm_file = args.dm_file or default_dm_file()
    prior = HmmPrior.load(dm_file)
    hmm = ProfileHMM.build(msa, args.symfrac, prior, name=db_name)
    log.info("Banded HMM profile trained (K=%d, effN=%.2f)", hmm.K,
             hmm.eff_n)

    with open(args.tree_file) as fh:
        ntree = parse_newick(fh.read())
    tree = PTUnrooted.from_newick(ntree)
    log.info("Phylogenetic tree constructed with total %d nodes",
             tree.num_nodes)

    n_leaves = sum(tree.is_leaf(u) for u in range(tree.num_nodes))
    n_read = tree.load_msa(msa)
    if n_read != n_leaves:
        log.error("Unmatched MSA and tree: %d leaf seqs vs %d leaves",
                  n_read, n_leaves)
        return None
    tree.fix_branch_length(1e-5)  # BRANCH_EPS default

    if args.anno:
        tree.load_annotation(args.anno)
        log.info("Taxonomy annotation loaded")
    tree.format_name()
    tree.annotate(args.root)
    tree.calc_node_height()

    sm_file = args.sm_file or default_sm_file(args.sm_type)
    tree.model = load_model(sm_file)
    log.info("DNA substitution model loaded: %s", tree.model.name)

    msg_dtype = {"f64": np.float64, "f32": np.float32,
                 "f16": np.float16}[args.msg_dtype]
    if msg_dtype == np.float16 and tree.num_nodes > 2000:
        # per-site message log-likelihood magnitudes grow ~linearly
        # with leaf count (~4.3e3/site at 2k leaves measured); beyond
        # ~2k nodes they can exceed float16 max 65504 and silently
        # saturate msg_up/msg_down to -inf near the root
        log.error("--msg-dtype f16 would overflow at %d nodes "
                  "(per-site magnitudes exceed float16 range above "
                  "~2000 nodes); use f32 or f64", tree.num_nodes)
        return None
    log.info("Evaluating phylogenetic tree (single two-pass sweep)")
    tree.evaluate(dtype=msg_dtype, engine=args.eval_engine,
                  device=device)

    if args.var:
        muts = tree.estimate_num_mutations()
        alpha = DiscreteGammaModel.estimate_shape_moment(muts)
        if not np.isfinite(alpha) or alpha <= 0:
            log.warning("Unable to estimate dGamma shape; using fixed "
                        "rate model")
        else:
            log.info("Estimated dGamma alpha = %g", alpha)
            tree.dg = DiscreteGammaModel(alpha, args.dg_k)
            # re-evaluate with the rate mixture
            tree.evaluate(dtype=msg_dtype, engine=args.eval_engine,
                          device=device)

    log.info("Final tree log-likelihood: %.6f", tree.tree_loglik())
    tree.infer_seq()
    log.info("Ancestral sequences inferred")
    return Database(msa, csfm, hmm, tree)


if __name__ == "__main__":
    sys.exit(main())
