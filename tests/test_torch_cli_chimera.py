"""Chimera checking of the port's assign on the CPU, against the
reference package's CLI on the 70_otus fixture DB.

With -C the device only aligns; each read's segments are placed on the
host in f64 by the same functions in both packages, so with equal
alignments the two give the same rows byte for byte: the same chimera
decisions and lods, the same --chimera-out rows and the same placements
of the clean reads.  The port builds no DevicePlacer under -C (the
reference CLI builds one and never uses it): the tests patch the class to
raise.  The synthetic chimera is that of tests/test_pipeline.py
TestChimera."""

import numpy as np
import pytest

from test_torch_pipeline import (db_prefix, one_torch_thread,  # noqa: F401
                                 simulate_reads)

N_CLEAN = 12


def ungapped(tree, u, lo, n):
    codes = tree.seqs[u]
    pos = np.nonzero(codes >= 0)[0]
    return "".join("ACGT"[c] for c in codes[pos[lo:lo + n]])


@pytest.fixture(scope="module")
def chimera_reads(db_prefix, tmp_path_factory):  # noqa: F811
    """A contiguous chimera (5' of an archaeon, 3' of a bacterium at the
    same ungapped offset), one clean read of the bacterium and N_CLEAN
    simulated reads."""
    from hmmufotu_tpu_torch.db import Database
    tree = Database.load(db_prefix).ptu
    leaves = [u for u in range(tree.num_nodes)
              if tree.is_leaf(u) and tree.msa_id[u] >= 0]
    u5 = next(u for u in leaves if tree.anno[u].startswith("k__Arch"))
    u3 = next(u for u in leaves if tree.anno[u].startswith("k__Bact"))
    recs = [("chimera", ungapped(tree, u5, 10, 120)
             + ungapped(tree, u3, 130, 120)),
            ("clean", ungapped(tree, u3, 400, 240))]
    recs += [(f"s{i}", s) for i, s in
             enumerate(simulate_reads(tree, N_CLEAN, seed=5))]
    path = tmp_path_factory.mktemp("chim") / "chim.fasta"
    path.write_text("".join(f">{rid}\n{s}\n" for rid, s in recs))
    return str(path)


def body(path):
    return [line for line in open(path) if not line.startswith("#")]


@pytest.fixture
def no_placer(monkeypatch):
    """DevicePlacer patched to raise: a -C run must not build one."""
    from hmmufotu_tpu_torch.phylo import placement

    class Refused:
        def __init__(self, *a, **kw):
            raise AssertionError("assign -C built a DevicePlacer")

    monkeypatch.setattr(placement, "DevicePlacer", Refused)


def port_chimera_rows(db_prefix, reads, tmp_path, tag, flags):  # noqa: F811
    from hmmufotu_tpu_torch.cli.assign import main
    out, chi = tmp_path / f"{tag}.tsv", tmp_path / f"{tag}_chi.tsv"
    assert main([db_prefix, reads, "-o", str(out), "-C", "--chimera-out",
                 str(chi), "-s", "1", *flags], device="cpu") == 0
    return body(out), body(chi)


@pytest.mark.parametrize("num_segment", [2, 4])
def test_chimera_rows_match_reference(db_prefix, chimera_reads,  # noqa: F811
                                      tmp_path, num_segment, no_placer):
    from hmmufotu_tpu.cli.assign import main as ref_main
    from hmmufotu_tpu_torch.cli.assign import main
    got = {}
    for tag, fn in (("ref", ref_main),
                    ("port", lambda a: main(a, device="cpu"))):
        out, chi = tmp_path / f"{tag}.tsv", tmp_path / f"{tag}_chi.tsv"
        assert fn([db_prefix, chimera_reads, "-o", str(out), "-C",
                   "--num-segment", str(num_segment), "--chimera-out",
                   str(chi), "-S", "0", "-s", "1"]) == 0
        got[tag] = (body(out), body(chi))
    assert got["port"] == got["ref"]
    rows, chi_rows = got["port"]
    head = rows[0].rstrip("\n").split("\t")
    assert head[10:15] == ["seg5_taxon_id", "seg3_taxon_id",
                           "seg5_taxon_anno", "seg3_taxon_anno",
                           "chimera_lod"]
    main_ids = {r.split("\t")[0] for r in rows[1:]}
    chi_ids = {r.split("\t")[0] for r in chi_rows[1:]}
    assert len(main_ids) + len(chi_ids) == N_CLEAN + 2
    assert "clean" in main_ids
    lods = {r.split("\t")[0]: float(r.split("\t")[14]) for r in rows[1:]}
    assert all(np.isfinite(v) for v in lods.values())
    if num_segment == 2:
        assert "chimera" in chi_ids
        assert not chi_ids & ({"clean"} | {f"s{i}" for i in range(N_CLEAN)})


@pytest.mark.parametrize("num_segment", [2, 4])
def test_chimera_rows_do_not_depend_on_batch(db_prefix,  # noqa: F811
                                             chimera_reads, tmp_path,
                                             num_segment, no_placer):
    """-b 8 splits the reads into two batches: the same main and
    --chimera-out rows as the CPU default batch (64, one batch), without
    -S, as assign --num-processes runs."""
    seg = ["--num-segment", str(num_segment)]
    one = port_chimera_rows(db_prefix, chimera_reads, tmp_path, "b64", seg)
    two = port_chimera_rows(db_prefix, chimera_reads, tmp_path, "b8",
                            seg + ["-b", "8"])
    assert one == two
    assert len(one[0]) + len(one[1]) == N_CLEAN + 2 + 2   # + two headers


@pytest.mark.parametrize("flags, built", [
    ([], 1), (["--mesh"], 1), (["--mesh-tree"], 1), (["-C"], 0)],
    ids=["stream", "mesh", "mesh-tree", "chimera"])
def test_placer_built_only_where_used(db_prefix, chimera_reads,  # noqa: F811
                                      tmp_path, monkeypatch, flags, built):
    """The assign CLI builds its DevicePlacer once for the stream and the
    batch loop over a mesh, and not at all under -C."""
    from hmmufotu_tpu_torch.cli.assign import main
    from hmmufotu_tpu_torch.phylo import placement
    made = []

    class Counted(placement.DevicePlacer):
        def __init__(self, *a, **kw):
            made.append(1)
            super().__init__(*a, **kw)

    monkeypatch.setattr(placement, "DevicePlacer", Counted)
    assert main([db_prefix, chimera_reads, "-o", str(tmp_path / "a.tsv"),
                 "-s", "1", *flags], device="cpu") == 0
    assert len(made) == built
