"""The reference DB of a configuration, built once in a checkout and
loaded by every run.

A user builds or downloads the DB once and every `assign` run loads it.
The first run of a configuration in a checkout builds the host pieces
with the program's own build code (cli.build.build_database on the
generated MSA, tree and taxonomy) and keeps them under
portbench/.cache/, keyed by the DB's shape and db_seed (the MSA, CSFM
index and profile HMM every configuration of that shape shares) and by
the configuration's name (the tree, its sequences and its model).  The
messages are not kept: each run evaluates them on the card, in place
of reading the 16 GB .ptu.npz, which no run may write.

Beside them the benchmark keeps its own plain arrays of the generated
inputs (the leaves' codes, the tree text, the lineages), from which the
traffic and the reference are made, and the reference's own profile
tables and Gamma shape, worked out from those arrays alone.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".cache")


class DbCache:
    """Paths of one configuration's cached DB; build() fills what is
    missing."""

    def __init__(self, config: dict):
        self.config = config
        shape = f"db-{config['leaves']}x{config['columns']}-seed{config['db_seed']}"
        self.shared = os.path.join(CACHE, shape)
        self.own = os.path.join(self.shared, config["name"])
        self.inputs = os.path.join(self.shared, "inputs.npz")
        self.tree_text = os.path.join(self.shared, "synth.tree")
        self.msa = os.path.join(self.shared, "db.msa.npz")
        self.csfm = os.path.join(self.shared, "db.csfm.npz")
        self.hmm = os.path.join(self.shared, "db.hmm")
        self.ref_hmm = os.path.join(self.shared, "ref_hmm.npz")
        self.ptu = os.path.join(self.own, "db.ptu.npz")
        self.ref_model = os.path.join(self.own, "ref_model.json")

    def complete(self) -> bool:
        return all(os.path.exists(p) for p in (
            self.inputs, self.tree_text, self.msa, self.csfm, self.hmm,
            self.ref_hmm, self.ptu, self.ref_model))

    def build(self, dev, log) -> dict:
        """Build what is missing; returns seconds by stage."""
        from . import gen
        cfg = self.config
        t = {}
        os.makedirs(self.own, exist_ok=True)
        work = os.path.join(self.shared, "inputs")
        if not (os.path.exists(self.inputs) and os.path.exists(
                self.tree_text)) or not os.path.isdir(work):
            t0 = time.perf_counter()
            g = gen.synth_inputs(work, cfg["leaves"], cfg["columns"],
                                 cfg["db_seed"], cfg["gamma_alpha"],
                                 cfg["gamma_categories"])
            np.savez(self.inputs + ".part.npz", **g)
            os.replace(self.inputs + ".part.npz", self.inputs)
            shutil.copyfile(os.path.join(work, gen.TREE), self.tree_text)
            t["synth_inputs"] = time.perf_counter() - t0
            log(f"inputs generated in {t['synth_inputs']:.1f} s")
        if not os.path.exists(self.ptu) or not all(
                os.path.exists(p) for p in (self.msa, self.csfm, self.hmm)):
            t0 = time.perf_counter()
            self._port_build(work, dev)
            t["port_build"] = time.perf_counter() - t0
            log(f"program build in {t['port_build']:.1f} s")
        if not os.path.exists(self.ref_hmm):
            from .reference.hmm_ref import estimate_hmm
            t0 = time.perf_counter()
            codes = np.load(self.inputs)["codes"]
            tab = estimate_hmm(codes, gen.DM_FILE)
            np.savez(self.ref_hmm + ".part.npz", **tab)
            os.replace(self.ref_hmm + ".part.npz", self.ref_hmm)
            t["reference_hmm"] = time.perf_counter() - t0
            log(f"reference profile in {t['reference_hmm']:.1f} s")
        if not os.path.exists(self.ref_model):
            t0 = time.perf_counter()
            alpha = None
            if cfg["gamma_shape"]:
                from .reference.messages import estimate_alpha
                alpha = estimate_alpha(reference_tree(self, None), dev)
            with open(self.ref_model + ".part", "w") as fh:
                json.dump({"alpha": alpha,
                           "categories": cfg["gamma_categories"]}, fh)
            os.replace(self.ref_model + ".part", self.ref_model)
            t["reference_model"] = time.perf_counter() - t0
        if os.path.isdir(work) and self._all_configs_built():
            shutil.rmtree(work)
        return t

    def _all_configs_built(self) -> bool:
        """Whether the fasta inputs can go: kept while a configuration of
        this shape that BENCHMARK.json names has no tree yet."""
        bench = json.load(open(os.path.join(os.path.dirname(HERE),
                                            "BENCHMARK.json")))
        for entry in bench["configs"]:
            c = json.load(open(os.path.join(HERE, "configs",
                                            entry["name"] + ".json")))
            if (c["leaves"], c["columns"], c["db_seed"]) == (
                    self.config["leaves"], self.config["columns"],
                    self.config["db_seed"]) and not os.path.exists(
                    os.path.join(self.shared, c["name"], "db.ptu.npz")):
                return False
        return True

    def _port_build(self, work: str, dev):
        """cli.build.build_database on the generated files with the
        configuration's build flags; the messages are dropped before the
        tree is saved."""
        import gc
        from hmmufotu_tpu_torch.cli.build import (build_database,
                                                  build_parser)
        from . import gen
        argv = [os.path.join(work, gen.FASTA), os.path.join(work, gen.TREE),
                "-a", os.path.join(work, gen.TAXONOMY), "-n", "db",
                "-sm", gen.SM_FILE, "-dm", gen.DM_FILE,
                *self.config["build_args"]]
        args = build_parser().parse_args(argv)
        db = build_database(args, "db", device=dev)
        if db is None:
            raise RuntimeError("the build refused the generated inputs")
        part = self.shared + "/.part"
        if not os.path.exists(self.msa):
            db.msa.save(part + ".msa.npz")
            os.replace(part + ".msa.npz", self.msa)
        if not os.path.exists(self.csfm):
            db.csfm.save(part + ".csfm.npz")
            os.replace(part + ".csfm.npz", self.csfm)
        if not os.path.exists(self.hmm):
            db.hmm.to_hmmer_file(part + ".hmm")
            os.replace(part + ".hmm", self.hmm)
        db.ptu.msg_up = db.ptu.msg_down = None
        db.ptu.save(part + ".ptu.npz")
        os.replace(part + ".ptu.npz", self.ptu)
        del db
        gc.collect()


def reference_tree(cache: DbCache, rates):
    """The reference's tree: the generated Newick in the reference's
    node numbering, each leaf's codes in node order, the model read
    from portbench/data."""
    from . import gen
    from .reference.messages import RefTree, parse_newick
    from .reference.ref_model import RefModel
    names, parent, brlen = parse_newick(open(cache.tree_text).read())
    g = np.load(cache.inputs)
    leaf_codes = g["codes"]
    N = len(names)
    is_leaf = np.zeros(N, bool)
    row = np.full(N, -1, np.int64)
    for u, nm in enumerate(names):
        if nm.startswith("S"):
            is_leaf[u] = True
            row[u] = int(nm[1:])
    brlen[is_leaf & (brlen <= 0)] = 1e-5        # the build's fixBranchLength
    codes = np.full((N, leaf_codes.shape[1]), -1, np.int8)
    codes[is_leaf] = leaf_codes[row[is_leaf]]
    tree = RefTree(parent, brlen, codes, is_leaf,
                   RefModel.from_sm_file(gen.SM_FILE), rates)
    tree.names = names
    tree.lineage = {f"S{i}": str(x) for i, x in enumerate(g["lineage"])}
    return tree


def main(argv) -> int:
    """python -m portbench.dbcache <config> <device>: build what the
    configuration's cache lacks."""
    import sys
    import torch
    cfg = json.load(open(os.path.join(HERE, "configs", argv[0] + ".json")))
    stages = DbCache(cfg).build(torch.device(argv[1]), lambda m: print(
        f"[portbench] {m}", file=sys.stderr, flush=True))
    print(f"[portbench] DB cache stages: {stages}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main(sys.argv[1:]))
