"""OTU summarizer CLI (reference: src/hmmufotu-sum.cpp).

Re-parses per-sample assignment TSVs, filters by taxon/qTaxon/
identities, accumulates OTUObserved per node, and writes the OTU
table plus optional read lists, posterior consensus seqs, OTU tree
and pseudo-tree (hmmufotu-sum.cpp:340-471).

Host counterpart of hmmufotu_tpu/cli/sum.py on this package's own
modules; the same arguments give the same output.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

from . import PROG_NAME, prog_header, setup_logging
from ..alphabet import DNA
from ..db import Database
from ..otu import OTUObserved, OTUTable
from ..seq import PrimarySeq, SeqWriter
from .. import pipeline as pl

log = logging.getLogger(__name__)

DEFAULT_EFFN = 2.0   # hmmufotu-sum.cpp:58


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=f"{PROG_NAME}-sum",
        description="Summarize read assignments into an OTU table")
    p.add_argument("db")
    p.add_argument("inputs", nargs="+", help="assignment TSV files")
    p.add_argument("-o", dest="out", required=True, help="OTU table out")
    p.add_argument("-l", "--read-list", default="")
    p.add_argument("-c", "--cs", default="",
                   help="write OTU consensus seqs fasta")
    p.add_argument("-t", "--tree", default="", help="write OTU tree")
    p.add_argument("-pt", "--ptree", default="",
                   help="write pseudo-tree with OTU leaves")
    p.add_argument("-s", "--samples", nargs="*", default=[],
                   help="sample names (default: file basenames)")
    p.add_argument("-n", "--min-read", type=int, default=0)
    p.add_argument("-m", "--min-sample", type=int, default=0)
    p.add_argument("-q", dest="min_q", type=float, default=0.0)
    p.add_argument("--aln-iden", type=float, default=0.0)
    p.add_argument("--hmm-iden", type=float, default=0.0)
    p.add_argument("-e", "--effN", type=float, default=DEFAULT_EFFN)
    p.add_argument("-p", "--prefix", default="OTU_")
    p.add_argument("-g", "--no-gap", action="store_true")
    p.add_argument("-v", action="count", default=0, dest="verbose")
    return p


def parse_assignment_tsv(path):
    """Yield dict rows of an assignment TSV (header-aware, the
    TSVScanner equivalent, reference util/TSVScanner.{h,cpp})."""
    with open(path) as fh:
        header = None
        for line in fh:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            if header is None:
                header = line.split("\t")
                continue
            yield dict(zip(header, line.split("\t")))


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    args = build_parser().parse_args(argv)
    setup_logging(args.verbose + 1)

    db = Database.load(args.db)
    tree, hmm = db.ptu, db.hmm
    L = tree.cs_len
    S = len(args.inputs)
    samples = args.samples or [
        os.path.basename(f).split(".")[0] for f in args.inputs]

    otu_data: dict[int, OTUObserved] = {}
    otu2read: dict[str, list[str]] = {}
    for s, path in enumerate(args.inputs):
        log.info("Processing sample %s ...", samples[s])
        for rec in parse_assignment_tsv(path):
            try:
                taxon_id = int(rec["taxon_id"])
                q_taxon = float(rec["Q_taxon"])
                cs_start = int(rec["CS_start"])
                cs_end = int(rec["CS_end"])
            except (KeyError, ValueError):
                continue
            aln = rec.get("alignment", "")
            if taxon_id < 0 or q_taxon < args.min_q:
                continue
            if args.aln_iden and pl.align_identity(
                    DNA, aln, cs_start - 1, cs_end - 1) < args.aln_iden:
                continue
            if args.hmm_iden and pl.hmm_identity(
                    hmm, aln, cs_start - 1, cs_end - 1) < args.hmm_iden:
                continue
            if taxon_id not in otu_data:
                otu_data[taxon_id] = OTUObserved(
                    args.prefix + str(taxon_id),
                    tree.anno[taxon_id], L, S)
            otu = otu_data[taxon_id]
            codes = DNA.encode_upper(aln)
            otu.add_seq(s, codes)
            if args.read_list:
                otu2read.setdefault(otu.otu_id, []).append(rec["id"])

    log.info("Computing OTUTable")
    table = OTUTable()
    for name in samples:
        table.add_sample(name)
    otu_seen: set[int] = set()
    for node in sorted(otu_data):
        otu = otu_data[node]
        n_samples_hit = int((otu.count > 0).sum())
        if otu.total >= args.min_read and n_samples_hit >= args.min_sample:
            table.add_otu(otu.otu_id, otu.taxon, otu.count)
            otu_seen.add(node)
        else:
            otu2read.pop(otu.otu_id, None)

    with open(args.out, "w") as fh:
        fh.write(prog_header([f"{PROG_NAME}-sum"] + list(argv)))
        table.save_table(fh)
    log.info("OTU table written: %d OTUs x %d samples", table.num_otus,
             table.num_samples)

    if args.read_list:
        with open(args.read_list, "w") as fh:
            fh.write(prog_header([f"{PROG_NAME}-sum"] + list(argv)))
            for otu_id in table.otus:
                fh.write(f"{otu_id}\t"
                         + " ".join(otu2read.get(otu_id, [])) + "\n")

    if args.cs:
        log.info("Writing OTU consensus sequences")
        w = SeqWriter(args.cs)
        for node in sorted(otu_seen):
            otu = otu_data[node]
            cs_codes = tree.infer_post_cs(node, otu.freq, otu.gap,
                                          args.effN)
            seq = DNA.decode(cs_codes)
            n_read = int(otu.total)
            n_hit = int((otu.count > 0).sum())
            desc = (f"DBName={args.db};Taxonomy=\"{tree.anno[node]}\";"
                    f"AnnoDist={tree.anno_dist[node]:g};"
                    f"ReadCount={n_read};SampleHits={n_hit}")
            rec = PrimarySeq(otu.otu_id, seq, desc)
            if args.no_gap:
                rec = rec.remove_gaps()
            w.write(rec)
        w.close()

    if args.tree or args.ptree:
        ancestors = set()
        for u in otu_seen:
            p = u
            while p >= 0:
                ancestors.add(int(p))
                p = int(tree.parent[p]) if tree.parent[p] >= 0 else -1
        if args.tree:
            with open(args.tree, "w") as fh:
                fh.write(tree.to_newick(subset=ancestors,
                                        prefix=args.prefix))
        if args.ptree:
            # pseudo-tree: graft a 0-length leaf copy at each observed
            # internal OTU so OTU ids point at leaves (reference
            # addPseudoLeaf, PhyloTreeUnrooted.cpp:376-412)
            tree.add_pseudo_leaf(otu_seen)
            ancestors2 = set()
            for u in otu_seen:
                p = u
                while p >= 0:
                    ancestors2.add(int(p))
                    p = int(tree.parent[p]) if tree.parent[p] >= 0 \
                        else -1
            with open(args.ptree, "w") as fh:
                fh.write(tree.to_newick(subset=ancestors2,
                                        prefix=args.prefix))
    return 0


if __name__ == "__main__":
    sys.exit(main())
