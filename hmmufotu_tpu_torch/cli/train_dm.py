"""Dirichlet prior trainer CLI (reference: src/hmmufotu-train-dm.cpp).

Partitions MSA columns into match/insert by symfrac, builds weighted
emission and transition count matrices (:253-344), then ML-trains the
match-emission Dirichlet mixture (multi-seed) and the four Dirichlet
densities (:345-370).

Counterpart of hmmufotu_tpu/cli/train_dm.py, on this package's modules.
"""

from __future__ import annotations

import argparse
import logging
import math
import sys

import numpy as np

from . import PROG_NAME, setup_logging
from ..mathx.dirichlet import DirichletDensity, DirichletMixture, HmmPrior
from ..msa import MSA

log = logging.getLogger(__name__)

DEFAULT_QM = 5          # hmmufotu-train-dm.cpp:49
DEFAULT_SYMFRAC = 0.5
DEFAULT_PRI_RATE = 0.05
DEFAULT_NSEED = 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=f"{PROG_NAME}-train-dm",
        description="Train a Banded-HMM Dirichlet prior from an MSA")
    p.add_argument("msa_file")
    p.add_argument("-o", dest="out", required=True)
    p.add_argument("-qM", type=int, default=DEFAULT_QM)
    p.add_argument("--symfrac", type=float, default=DEFAULT_SYMFRAC)
    p.add_argument("--pri-rate", type=float, default=DEFAULT_PRI_RATE)
    p.add_argument("-n", dest="n_seed", type=int, default=DEFAULT_NSEED)
    p.add_argument("-S", "--seed", type=int, default=None)
    p.add_argument("-v", action="count", default=0, dest="verbose")
    return p


def prepare_training_data(msa: MSA, symfrac: float):
    """Emission + transition count matrices
    (reference hmmufotu-train-dm.cpp:253-332)."""
    L = msa.cs_len
    sym_wfrac = msa.sym_wfrac()
    is_match = sym_wfrac >= symfrac
    wfreq = msa.sym_wfreq()                    # [4, L]
    # observation matrices are [K, n_cols] (symbols x columns), the
    # orientation DirichletModel.train_ml/cost consume (the reference's
    # Eigen MatrixXd with one observation per column,
    # hmmufotu-train-dm.cpp:253-344)
    data_me = wfreq[:, is_match]               # [4, cME]
    data_ie = wfreq[:, ~is_match]

    codes = msa.codes
    w = msa.seq_weight
    N = msa.num_seq
    is_res = codes >= 0

    data_mt, data_it, data_dt = [], [], []
    col_mt = np.zeros(3)
    col_it = np.zeros(2)
    col_dt = np.zeros(2)
    # per-seq next informative position (match col or residue)
    informative = is_match[None, :] | is_res          # [N, L]
    for j in range(L - 1):
        m = is_match[j]
        for i in range(N):
            res = is_res[i, j]
            if not m and not res:
                continue
            nxt = np.nonzero(informative[i, j + 1:])[0]
            if nxt.size == 0:
                continue
            k = j + 1 + nxt[0]
            mN, resN = is_match[k], is_res[i, k]
            if m and res:
                if mN and resN:
                    col_mt[0] += w[i]
                elif not mN and resN:
                    col_mt[1] += w[i]
                elif mN and not resN:
                    col_mt[2] += w[i]
            elif not m and res:
                if mN and resN:
                    col_it[0] += w[i]
                elif not mN and resN:
                    col_it[1] += w[i]
            elif m and not res:
                if mN and resN:
                    col_dt[0] += w[i]
                elif mN and not resN:
                    col_dt[1] += w[i]
        if col_mt.any():
            data_mt.append(col_mt)
            col_mt = np.zeros(3)
        if col_it.any():
            data_it.append(col_it)
            col_it = np.zeros(2)
        if col_dt.any():
            data_dt.append(col_dt)
            col_dt = np.zeros(2)
    return (data_me, data_ie, np.array(data_mt).T, np.array(data_it).T,
            np.array(data_dt).T)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(args.verbose + 1)
    rng = np.random.default_rng(args.seed)

    msa = MSA.load_fasta(args.msa_file)
    msa.prune()
    log.info("MSA loaded: %d x %d", msa.num_seq, msa.cs_len)
    eff_n = 1.0 / args.pri_rate
    msa.scale_weight(eff_n / msa.num_seq)

    data_me, data_ie, data_mt, data_it, data_dt = \
        prepare_training_data(msa, args.symfrac)
    log.info("Training data: ME %d IE %d MT %d IT %d DT %d cols",
             data_me.shape[1], data_ie.shape[1], data_mt.shape[1],
             data_it.shape[1], data_dt.shape[1])

    pri = HmmPrior()
    best_cost = math.inf
    for s in range(args.n_seed):
        model = DirichletMixture(k=4, l=args.qM)
        cost = model.train_ml(data_me, rng=rng)
        log.info("  seed %d trained, cost: %g", s + 1, cost)
        if cost < best_cost:
            pri.dmME = model
            best_cost = cost
    if math.isnan(best_cost):
        log.error("Unable to train Match Emission model")
        return 1

    pri.dmIE = DirichletDensity(k=4)
    pri.dmIE.train_ml(data_ie)
    pri.dmMT = DirichletDensity(k=3)
    pri.dmMT.train_ml(data_mt)
    pri.dmIT = DirichletDensity(k=2)
    pri.dmIT.train_ml(data_it)
    pri.dmDT = DirichletDensity(k=2)
    pri.dmDT.train_ml(data_dt)
    log.info("All prior models trained")

    pri.save(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
