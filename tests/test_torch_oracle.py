"""The port against the independent f64 oracle (tests/oracle/, numpy
only), on the CPU: tests/test_oracle_parity.py's four cases on the port's
stack, run by scripts/torch_run_parity.py's harness, and a small run of
that script's sweep.

Each stage goes through the port's own entry point (build and sim CLIs,
pipeline.align_reads with the aligner's plain version, assign_batch_device
with the placer's, and assign_read on the host).  The rules are the
original's: single-end reads with no mismatch by compare_read (alignment
string, coordinates, cost within 1e-4 relative / 5e-3 absolute; taxon;
branch, or a same-taxon tie within 0.05 qPlace; loglik within 1e-6
relative / 1e-4 absolute); pairs with the merged alignment and cs bounds
equal and the same taxon; the host path on the oracle's branch and
taxon."""

import json
import os
import sys

import numpy as np
import pytest

from test_torch_pipeline import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import torch_run_parity as trp  # noqa: E402


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """The JC69 and the GTR+dGamma4 70_otus DBs, built once by the port's
    build CLI."""
    work = str(tmp_path_factory.mktemp("oracle_dbs"))
    return {"JC69": trp.build_db(work, "JC69", False),
            "GTR-dG4": trp.build_db(work, "GTR", True)}


@pytest.mark.parametrize("db,n,seed,paired", [
    ("JC69", 20, 11, False), ("GTR-dG4", 20, 12, False),
    ("GTR-dG4", 10, 13, True)], ids=["jc69_se", "gtr_dg4_se", "gtr_dg4_pe"])
def test_oracle_parity(dbs, tmp_path, db, n, seed, paired):
    model, dgamma = ("JC69", False) if db == "JC69" else ("GTR", True)
    s = trp.run_sweep(str(tmp_path), model, dgamma, n, seed, paired, db,
                      device="cpu", prefix=dbs[db])
    assert s["n"] == n
    if paired:
        assert s["aln_mismatch"] == 0 and s["taxon_mismatch"] == 0, \
            s["details"]
    else:
        assert s["aln_mismatch"] == s["cat_mismatch"] \
            == s["score_mismatch"] == 0, s["details"]


def test_host_path_matches_oracle(dbs, tmp_path):
    """The exact host path (pipeline.assign_read) lands on the oracle's
    branch and taxon for every read, each aligned as the oracle aligns
    it."""
    s = trp.run_sweep(str(tmp_path), "JC69", False, 6, 21, False, "host",
                      device="cpu", host_n=6, prefix=dbs["JC69"])
    assert s["host_n"] == 6
    assert s["host_taxon_mismatch"] == s["host_branch_mismatch"] == 0


def test_sweep_small(tmp_path, capsys):
    """The script's whole sweep on 10 reads a configuration (and 10 for
    the band deviation), the oracle in two processes: exit 0, one JSON
    line a configuration in order, the JAX package's counts beside."""
    assert trp.main(["--device", "cpu", "-n", "10", "--band-n", "10",
                     "--jobs", "2", "--host-n", "2",
                     "--work", str(tmp_path)]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [x.get("tag") for x in lines[:4]] == [
        "JC69-SE", "GTR-dG4-SE", "GTR-dG4-PE", "band"]
    assert all(x["n"] == 10 for x in lines[:4])
    assert lines[0]["host_n"] == 2
    assert set(lines[4]["port_vs_jax"]) == {
        "JC69-SE", "GTR-dG4-SE", "GTR-dG4-PE", "band"}


@pytest.mark.parametrize("db", ["JC69", "GTR-dG4"])
def test_oracle_reads_the_references_arrays(dbs, db):
    """Every attribute the oracle reads off the port's ProfileHMM, MSA and
    PTUnrooted (RefHmm.from_production, RefLocator, OracleTree) is the
    JAX package's: the same type, dtype and values on the same DB."""
    from hmmufotu_tpu.db import Database as RefDB
    from hmmufotu_tpu_torch.db import Database
    from hmmufotu_tpu_torch.hmm import NGCL
    ref, port = RefDB.load(dbs[db]), Database.load(dbs[db])
    for d in (ref, port):
        d.hmm.set_sequence_mode(NGCL)

    def same(a, b, what):
        assert type(a) is type(b), what
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, what
            np.testing.assert_array_equal(a, b, err_msg=what)
        else:
            assert a == b, what

    for k in ("K", "L", "Tmat", "Tmat_cost", "E_M_cost", "E_I_cost",
              "t_NN_cost", "t_NB_cost", "t_CC_cost", "t_EC_cost",
              "cs2profile", "profile2cs"):
        same(getattr(ref.hmm, k), getattr(port.hmm, k), f"hmm.{k}")
    same(ref.msa.chars, port.msa.chars, "msa.chars")
    for k in ("parent", "brlen", "seqs", "heights", "anno", "cs_len",
              "root"):
        same(getattr(ref.ptu, k), getattr(port.ptu, k), f"ptu.{k}")
    # the oracle widens the messages to f64 (OracleTree); the port's load
    # keeps the file's f32, which widen to the reference's f64 exactly
    for k in ("msg_up", "msg_down"):
        same(getattr(ref.ptu, k),
             np.asarray(getattr(port.ptu, k), dtype=np.float64), f"ptu.{k}")
    rm, pm = ref.ptu.model, port.ptu.model
    same(rm.name, pm.name, "model.name")
    for k in ("pi", "kappa", "kr", "ky", "Q"):
        if hasattr(rm, k):
            same(getattr(rm, k), getattr(pm, k), f"model.{k}")
    assert (ref.ptu.dg is None) == (port.ptu.dg is None)
    if ref.ptu.dg is not None:
        same(ref.ptu.dg.rates, port.ptu.dg.rates, "dg.rates")
