"""The port's io/reference_format against the reference package's: the
reference binary's .msa, .csfm and .ptu files and their libcds parts
(RRR bit vectors, the wavelet tree) written by the port are byte-equal
to the reference package's, each package loads the other's files, and
the round trips of tests/test_reference_format.py hold in the port."""

import os

import numpy as np
import pytest

import hmmufotu_tpu.io.reference_format as ref_io
import hmmufotu_tpu_torch.io.reference_format as io

from test_torch_pipeline import one_torch_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """The 70_otus DB (GTR + dGamma) built by the reference builder and
    loaded by each package: (reference Database, port Database)."""
    from hmmufotu_tpu.cli.build import main as build_main
    from hmmufotu_tpu.db import Database as RefDB
    from hmmufotu_tpu_torch.db import Database
    prefix = str(tmp_path_factory.mktemp("refio") / "70_otus")
    assert build_main([
        os.path.join(FIXTURES, "70_otus.fasta"),
        os.path.join(FIXTURES, "70_otus.tree"),
        "-a", os.path.join(FIXTURES, "70_otus_taxonomy.txt"),
        "-n", prefix, "-s", "GTR", "-V"]) == 0
    return RefDB.load(prefix), Database.load(prefix)


def write(path, fn, *args):
    with open(path, "wb") as fh:
        fn(fh, *args)
    return path.read_bytes()


@pytest.mark.parametrize("n", [1, 15, 16, 4096, 12345])
def test_rrr_bytes_equal(tmp_path, n):
    rng = np.random.default_rng(n)
    for p in (0.02, 0.5, 0.97):
        bits = rng.random(n) < p
        got = write(tmp_path / "port.bin", io.rrr_save, bits)
        assert got == write(tmp_path / "ref.bin", ref_io.rrr_save, bits)
        for load in (io.rrr_load, ref_io.rrr_load):
            with open(tmp_path / "port.bin", "rb") as fh:
                assert (load(fh) == bits).all(), (n, p)


@pytest.mark.parametrize("syms", [np.arange(1), np.array([0, 4, 4, 0, 4]),
                                  np.random.default_rng(1).integers(
                                      0, 5, size=30000)],
                         ids=["one", "missing_symbol", "n30000"])
def test_wavelet_bytes_equal(tmp_path, syms):
    syms = syms.astype(np.uint32)
    got = write(tmp_path / "port.bin", io.wt_save, syms)
    assert got == write(tmp_path / "ref.bin", ref_io.wt_save, syms)
    for load in (io.wt_load, ref_io.wt_load):
        with open(tmp_path / "port.bin", "rb") as fh:
            assert (load(fh) == syms).all()


@pytest.mark.parametrize("part", ["msa", "csfm", "ptu"])
def test_file_bytes_equal_and_cross_load(dbs, tmp_path, part):
    """Each package writes the part of the same DB; the files are equal
    byte for byte, and each package loads the other's file."""
    ref_db, db = dbs
    save = getattr(io, f"save_reference_{part}")
    ref_save = getattr(ref_io, f"save_reference_{part}")
    port_f, ref_f = str(tmp_path / f"p.{part}"), str(tmp_path / f"r.{part}")
    save(getattr(db, part), port_f)
    ref_save(getattr(ref_db, part), ref_f)
    assert open(port_f, "rb").read() == open(ref_f, "rb").read()
    mine = getattr(io, f"load_reference_{part}")(ref_f)
    theirs = getattr(ref_io, f"load_reference_{part}")(port_f)
    assert type(mine).__module__.startswith("hmmufotu_tpu_torch.")
    assert_same(part, mine, theirs)
    assert_same(part, mine, getattr(db, part))


def assert_same(part, a, b):
    """The fields the reference round-trip tests compare."""
    if part == "msa":
        assert a.names == b.names and (a.chars == b.chars).all()
        assert a.get_cs() == b.get_cs()
        assert np.allclose(a.seq_weight, b.seq_weight)
    elif part == "csfm":
        assert a.cs_len == b.cs_len and a.concat_len == b.concat_len
        assert (np.asarray(a.bwt) == np.asarray(b.bwt)).all()
        assert (a.concat2cs == b.concat2cs).all()
        assert (a.sampled_rows == b.sampled_rows).all()
        assert (a.sampled_vals == b.sampled_vals).all()
        for pat in ("ACGTACGTACGTACGTACGT", "GGATTAGATACCCTGGTAGT"):
            assert a.count(pat) == b.count(pat)
            la, lb = a.locate_one(pat), b.locate_one(pat)
            assert (la.start, la.end, la.cs) == (lb.start, lb.end, lb.cs)
    else:
        assert a.cs_len == b.cs_len and a.root == b.root
        assert a.names == b.names and a.anno == b.anno
        assert (a.parent == b.parent).all() and (a.seqs == b.seqs).all()
        assert np.allclose(a.brlen, b.brlen)
        assert np.allclose(a.msg_up, b.msg_up)
        assert np.allclose(a.msg_down, b.msg_down)
        assert a.model.name == b.model.name
        assert (a.dg is None) == (b.dg is None)
        assert abs(a.tree_loglik() - b.tree_loglik()) < 1e-6


def test_db_round_trip_between_packages(dbs, tmp_path):
    """A DB the port saves in the reference layout loads in the
    reference package, and back: the same files, the same assignment of
    a read by the host SEP path in both packages."""
    import hmmufotu_tpu.pipeline as ref_pl
    import hmmufotu_tpu_torch.pipeline as pl
    ref_db, db = dbs
    port_p, ref_p = str(tmp_path / "port"), str(tmp_path / "ref")
    io.save_reference_db(db, port_p)
    ref_io.save_reference_db(ref_db, ref_p)
    for ext in (".msa", ".csfm", ".ptu"):
        assert open(port_p + ext, "rb").read() \
            == open(ref_p + ext, "rb").read()
    with open(port_p + ".msa", "rb") as fh:
        assert tuple(io.load_prog_info(fh)) == (1, 5, 1)
    back, ref_back = io.load_reference_db(ref_p), \
        ref_io.load_reference_db(port_p)
    tree, ref_tree = back.ptu, ref_back.ptu
    leaf = next(u for u in range(tree.num_nodes)
                if tree.is_leaf(u) and tree.msa_id[u] >= 0)
    seq = tree.seqs[leaf].copy()
    pos = np.nonzero(seq >= 0)[0]
    seq[:pos[100]] = -2
    seq[pos[300]:] = -2
    start, end = int(pos[100]), int(pos[299])
    got = []
    for p, t in ((pl, tree), (ref_pl, ref_tree)):
        locs = p.get_seed(t, seq, start, end)
        places = p.place_seq(t, seq, p.filter_placements(
            p.estimate_seq(t, seq, locs)))
        places.sort(key=lambda q: -q.loglik)
        got.append((places[0].c_node, places[0].a_node,
                    round(places[0].loglik, 6)))
    assert got[0] == got[1]
