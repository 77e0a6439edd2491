"""The slice as a whole on the CPU: the port's assign_stream and assign
CLI against the reference package on the 70_otus fixture.

The reference stream runs its TPU path, the traced Pallas Viterbi and
the fused SEP kernels, in interpret mode; the port runs the plain
versions of its kernels.  Both compute the D chain by the same doubling
and the same recurrences, so the alignments are equal.  Placements pick
the same nodes and taxa; numbers agree within the tolerances of
tests/test_pipeline.py (branch ratios 2e-3, logliks 1e-4 relative +
0.5), as the two sides sum sites in different orders."""

import functools
import os

import numpy as np
import pytest
import torch

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
BRANCH_ATOL = 2e-3
LL_RTOL, LL_ATOL = 1e-4, 0.5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch CPU thread while a test module runs: the suite runs test
    files in parallel worker processes, and a torch thread pool of every
    core in each of them oversubscribes the cores (its threads spin),
    several times slower than one thread each.  Test files of the port
    import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def db_prefix(tmp_path_factory):
    """The 70_otus DB, built once by the reference builder."""
    from hmmufotu_tpu.cli.build import main as build_main
    prefix = str(tmp_path_factory.mktemp("db") / "70_otus")
    assert build_main([os.path.join(FIXTURES, "70_otus.fasta"),
                       os.path.join(FIXTURES, "70_otus.tree"),
                       "-a", os.path.join(FIXTURES, "70_otus_taxonomy.txt"),
                       "-n", prefix, "-s", "GTR"]) == 0
    return prefix


def simulate_reads(tree, n, seed, length=250):
    """Mutated 250 bp leaf windows, as bench.py simulates them."""
    rng = np.random.default_rng(seed)
    leaves = [u for u in range(tree.num_nodes)
              if tree.is_leaf(u) and tree.msa_id[u] >= 0]
    reads = []
    while len(reads) < n:
        codes = tree.seqs[int(rng.choice(leaves))]
        pos = np.nonzero(codes >= 0)[0]
        if len(pos) < length + 10:
            continue
        st = int(rng.integers(0, len(pos) - length - 5))
        piece = codes[pos[st:st + length]].copy()
        mut = rng.random(len(piece)) < 0.02
        piece[mut] = rng.integers(0, 4, int(mut.sum()))
        reads.append("".join("ACGT"[c] for c in piece))
    return reads


def test_assign_stream_matches_reference(db_prefix, monkeypatch):
    import hmmufotu_tpu.hmm.pallas_viterbi as pv
    from hmmufotu_tpu import pipeline as ref_pl
    from hmmufotu_tpu.db import Database as RefDB
    from hmmufotu_tpu.hmm import ViterbiAligner as RefAligner
    from hmmufotu_tpu.phylo.placement import DevicePlacer as RefPlacer
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch.db import Database
    from hmmufotu_tpu_torch.hmm import NGCL, ViterbiAligner
    from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
    monkeypatch.setattr(pv, "viterbi_pallas_traced_split", functools.partial(
        pv.viterbi_pallas_traced_split, interpret=True))
    ref, db = RefDB.load(db_prefix), Database.load(db_prefix)
    for d in (ref, db):
        d.hmm.set_sequence_mode(NGCL)
        d.hmm.wing_retract()
    reads = simulate_reads(db.ptu, 64, seed=0)
    want = list(ref_pl.assign_stream(
        RefAligner(ref.hmm, kernel="pallas", traceback_mode="device"),
        ref.csfm, ref.ptu, RefPlacer(ref.ptu, sep_pallas=True), reads, 32,
        mode=NGCL))
    got = list(pl.assign_stream(
        ViterbiAligner(db.hmm, device="cpu"), db.csfm, db.ptu,
        DevicePlacer(db.ptu, device="cpu"), reads, 32, mode=NGCL))
    assert len(got) == len(want) == 2
    n = 0
    for (alns, best), (ref_alns, ref_best) in zip(got, want):
        for a, b, p, q in zip(alns, ref_alns, best, ref_best):
            n += 1
            assert a.align == b.align and a.cost == b.cost
            assert (a.cs_start, a.cs_end) == (b.cs_start, b.cs_end)
            assert p is not None and q is not None
            assert (p.c_node, p.p_node, p.a_node) == (q.c_node, q.p_node,
                                                      q.a_node)
            assert db.ptu.anno[p.a_node] == ref.ptu.anno[q.a_node]
            assert p.ratio == pytest.approx(q.ratio, abs=BRANCH_ATOL)
            assert p.wnr == pytest.approx(q.wnr, abs=BRANCH_ATOL)
            assert p.loglik == pytest.approx(q.loglik, rel=LL_RTOL,
                                             abs=LL_ATOL)
    assert n == 64


def read_tsv(path):
    rows = [line.rstrip("\n").split("\t") for line in open(path)
            if not line.startswith("#")]
    assert rows[0][0] == "id"
    return rows[0], rows[1:]


def test_assign_cli_matches_reference(db_prefix, tmp_path):
    """The port's assign CLI (device="cpu") against the reference CLI,
    both with -S 0: the same read ids and taxa on every row, the same
    branch ids, and branch ratios and logliks within the tolerances."""
    from hmmufotu_tpu.cli.assign import main as ref_main
    from hmmufotu_tpu.db import Database as RefDB
    from hmmufotu_tpu_torch.cli.assign import main
    reads = simulate_reads(RefDB.load(db_prefix).ptu, 40, seed=3)
    fa = tmp_path / "reads.fasta"
    fa.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    out_ref, out = tmp_path / "ref.tsv", tmp_path / "port.tsv"
    assert ref_main([db_prefix, str(fa), "-o", str(out_ref), "-S", "0"]) == 0
    assert main([db_prefix, str(fa), "-o", str(out), "-S", "0"],
                device="cpu") == 0
    head_ref, rows_ref = read_tsv(out_ref)
    head, rows = read_tsv(out)
    assert head == head_ref
    col = {name: i for i, name in enumerate(head)}
    assert len(rows) == len(rows_ref) == 40
    for r, q in zip(rows, rows_ref):
        for name in ("id", "CS_start", "CS_end", "branch_id", "taxon_id",
                     "taxon_anno"):
            assert r[col[name]] == q[col[name]], (r[0], name)
        assert float(r[col["branch_ratio"]]) == pytest.approx(
            float(q[col["branch_ratio"]]), abs=BRANCH_ATOL)
        assert float(r[col["loglik"]]) == pytest.approx(
            float(q[col["loglik"]]), rel=LL_RTOL, abs=LL_ATOL)
