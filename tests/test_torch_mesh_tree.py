"""assign --mesh-tree over four shards, as on a host of four cards,
against the reference package's CLI on a four-device CPU mesh.

The tree-sharded placer of both packages is not the single-device
placer.  Each shard takes the C candidates of its own node block nearest
the read, and drops those whose estimate lies more than max_error below
the best estimate of its block; the host merge then keeps the global top
C of the union.  A block whose own top C holds a candidate outside the
global top C with a better estimate drops candidates that one device
keeps, and the merged pick can be another branch with a lower loglik.
The port keeps this behaviour of the reference (ROADMAP parity rule 1);
tests/test_torch_cuda.py holds the cards' --mesh-tree rows against the
port's CPU shards, which this file holds against the reference.  Rows as
tests/test_torch_parallel.py compares them: the same ids, alignments,
branch and taxon, logliks within the pipeline tolerances."""

import os

import pytest

from conftest import run_on_cpu_mesh
from test_torch_parallel import rows_agree
from test_torch_pipeline import one_torch_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
SHARDS = 4

REF = """
from hmmufotu_tpu.cli.assign import main
import jax
assert len(jax.devices()) == {n}
assert main({argv!r} + ["-o", {out!r}, "--mesh-tree"]) == 0
"""


@pytest.fixture(scope="module")
def db_and_reads(tmp_path_factory, one_torch_thread):  # noqa: F811
    """The 70_otus GTR+dGamma4 DB built by the port's builder and the
    reads of tests/test_torch_cuda.py's cross-card test."""
    from hmmufotu_tpu_torch.cli.build import main as build_main
    from hmmufotu_tpu_torch.cli.sim import main as sim_main
    d = tmp_path_factory.mktemp("mesh_tree")
    prefix = str(d / "70_otus")
    assert build_main([os.path.join(FIXTURES, "70_otus.fasta"),
                       os.path.join(FIXTURES, "70_otus.tree"),
                       "-a", os.path.join(FIXTURES, "70_otus_taxonomy.txt"),
                       "-n", prefix, "-s", "GTR", "-V"]) == 0
    reads = str(d / "reads.fa")
    assert sim_main([prefix, reads, "-N", "48", "-S", "7", "-l",
                     "150"]) == 0
    return prefix, reads


def rows(path):
    return [line.rstrip("\n").split("\t") for line in open(path)
            if not line.startswith("#") and not line.startswith("id\t")]


def test_mesh_tree_four_shards_match_reference(db_and_reads, tmp_path,
                                               monkeypatch):
    from hmmufotu_tpu_torch import parallel
    from hmmufotu_tpu_torch.cli.assign import main
    prefix, reads = db_and_reads
    argv = [prefix, reads, "-b", "16"]
    out = {k: str(tmp_path / f"{k}.tsv") for k in ("ref", "port", "one")}
    res = run_on_cpu_mesh(REF.format(n=SHARDS, argv=argv, out=out["ref"]),
                          n_devices=SHARDS, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert main(argv + ["-o", out["one"]], device="cpu") == 0
    monkeypatch.setattr(parallel, "make_mesh",
                        lambda *a, **kw: parallel.sharding.make_mesh(
                            SHARDS, device="cpu"))
    assert main(argv + ["-o", out["port"], "--mesh-tree"],
                device="cpu") == 0
    port, ref, one = (rows(out[k]) for k in ("port", "ref", "one"))
    assert len(port) == 48
    rows_agree(port, ref)
    # these reads hold the case the docstring names: the shards' pick is
    # another branch than one device's on some of them, in both packages
    moved = [g[0] for g, w in zip(port, one) if g[10] != w[10]]
    assert moved
