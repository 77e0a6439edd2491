"""Assignment TSV -> jplace v3 JSON converter (reference:
src/hmmufotu-jplace.cpp:171-310).

Host counterpart of hmmufotu_tpu/cli/jplace.py on this package's own
modules; the same arguments give the same output.
"""

from __future__ import annotations

import argparse
import json
import logging
import re
import sys

from . import PROG_NAME, setup_logging
from ..alphabet import DNA
from ..db import Database
from .. import pipeline as pl
from .sum import parse_assignment_tsv

log = logging.getLogger(__name__)

JPLACE_VERSION = 3
FIELD_NAMES = ["edge_num", "likelihood", "like_weight_ratio",
               "distal_length", "proximal_length", "pendant_length"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=f"{PROG_NAME}-jplace",
        description="Convert assignment TSVs to jplace v3 JSON")
    p.add_argument("db")
    p.add_argument("inputs", nargs="+")
    p.add_argument("-o", dest="out", default="-")
    p.add_argument("-q", dest="min_q", type=float, default=0.0)
    p.add_argument("--sm", action="store_true",
                   help="include substitution model metadata")
    p.add_argument("--anno", action="store_true",
                   help="include node taxonomy annotations")
    p.add_argument("-v", action="count", default=0, dest="verbose")
    return p


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    args = build_parser().parse_args(argv)
    setup_logging(args.verbose + 1)

    db = Database.load(args.db)
    tree, hmm = db.ptu, db.hmm

    doc = {"tree": tree.to_jplace_tree() + ";"}
    placements = []
    for path in args.inputs:
        log.info("Processing %s ...", path)
        for rec in parse_assignment_tsv(path):
            try:
                taxon_id = int(rec["taxon_id"])
                q = float(rec["Q_placement"])
                cs_start = int(rec["CS_start"])
                cs_end = int(rec["CS_end"])
                ratio = float(rec["branch_ratio"])
                anno_dist = float(rec["anno_dist"])
                loglik = float(rec["loglik"])
            except (KeyError, ValueError):
                continue
            aln = rec.get("alignment", "")
            if not (taxon_id >= 0 and q >= args.min_q
                    and pl.align_identity(DNA, aln, cs_start - 1,
                                          cs_end - 1)
                    and pl.hmm_identity(hmm, aln, cs_start - 1,
                                        cs_end - 1)):
                continue
            m = re.match(r"(\d+)->(\d+)", rec["branch_id"])
            if not m:
                continue
            c_node = int(m.group(1))
            edge_len = float(tree.brlen[c_node])
            distal = edge_len * ratio
            proximal = edge_len * (1 - ratio)
            pendant = (anno_dist - distal) if ratio <= 0.5 \
                else (anno_dist - proximal)
            # NOTE: the reference sets like_weight_ratio = q2p(qPlace)
            # = 10^(-q/10), i.e. the posterior ERROR (JPlace ctor,
            # HmmUFOtu_main.cpp:241-247); replicated for parity
            like_ratio = 1.0 if q >= 250 else 10 ** (-q / 10)
            # edge id = child node id (PTUnrooted::getEdgeID)
            placements.append({
                "p": [[c_node, loglik, like_ratio, distal, proximal,
                       pendant]],
                "n": [rec["id"]],
            })
    doc["placements"] = placements
    doc["version"] = JPLACE_VERSION
    doc["fields"] = FIELD_NAMES
    metadata = {"invocation": " ".join([f"{PROG_NAME}-jplace"]
                                       + list(argv))}
    if args.sm and tree.model is not None:
        metadata["substitution_model"] = tree.model.name
        metadata["among_site_rate_variation"] = \
            "Discrete Gamma model" if tree.dg is not None else "none"
    if args.anno:
        metadata["node_taxonomy_annotations"] = {
            str(u): tree.anno[u] for u in range(tree.num_nodes)}
    doc["metadata"] = metadata

    out = sys.stdout if args.out == "-" else open(args.out, "w")
    json.dump(doc, out, indent=1)
    out.write("\n")
    if out is not sys.stdout:
        out.close()
    log.info("Wrote %d placements", len(placements))
    return 0


if __name__ == "__main__":
    sys.exit(main())
