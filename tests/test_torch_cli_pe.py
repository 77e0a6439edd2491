"""Paired-end assign and the read simulator of the port on the CPU,
against the reference package's CLIs on the 70_otus GTR+dGamma4 DB (the
reference's paired-end configuration, tests/test_pipeline.py
TestDGammaPE).

The port's sim is host numpy like the reference's: the same -S gives the
same reads, byte for byte.  Paired-end assign aligns the forward reads
and then the reverse-complemented mates in GLOBAL mode (the port's
plain K1 against the reference's kernel, equal alignments), merges the
mates and places the merged reads through the device placer: the same
ids, CS coordinates, branches and taxa; branch ratios and logliks
within the tolerances of tests/test_torch_pipeline.py."""

import os

import pytest

from test_torch_pipeline import (BRANCH_ATOL, LL_ATOL, LL_RTOL,  # noqa: F401
                                 one_torch_thread, read_tsv)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
N_PAIRS = 16
SIM_PE = ["--mean-size", "400", "--sd-size", "20", "-l", "150"]


@pytest.fixture(scope="module")
def dg_db(tmp_path_factory):
    """The 70_otus GTR+dGamma4 DB, built once by the reference builder."""
    from hmmufotu_tpu.cli.build import main as build_main
    prefix = str(tmp_path_factory.mktemp("dgdb") / "70_otus_dg")
    assert build_main([os.path.join(FIXTURES, "70_otus.fasta"),
                       os.path.join(FIXTURES, "70_otus.tree"),
                       "-a", os.path.join(FIXTURES, "70_otus_taxonomy.txt"),
                       "-n", prefix, "-s", "GTR", "-V", "-k", "4"]) == 0
    return prefix


@pytest.fixture(scope="module")
def pairs(dg_db, tmp_path_factory):
    """N_PAIRS simulated read pairs (reference sim, -S 7)."""
    from hmmufotu_tpu.cli.sim import main as sim_main
    d = tmp_path_factory.mktemp("pe")
    r1, r2 = str(d / "pe_1.fasta"), str(d / "pe_2.fasta")
    assert sim_main([dg_db, r1, "-m", r2, "-N", str(N_PAIRS), "-S", "7"]
                    + SIM_PE) == 0
    return r1, r2


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_sim_matches_reference(dg_db, tmp_path, paired):
    """The same -S gives byte-equal reads (and mates)."""
    from hmmufotu_tpu.cli.sim import main as ref_sim
    from hmmufotu_tpu_torch.cli.sim import main as sim
    outs = {}
    for tag, fn in (("ref", ref_sim), ("port", sim)):
        r1, r2 = str(tmp_path / f"{tag}_1.fa"), str(tmp_path / f"{tag}_2.fa")
        argv = [dg_db, r1, "-N", "24", "-S", "3"]
        argv += ["-m", r2] + SIM_PE if paired \
            else ["--mean-size", "300", "--sd-size", "20"]
        assert fn(argv) == 0
        outs[tag] = [open(r1, "rb").read()]
        if paired:
            outs[tag].append(open(r2, "rb").read())
    assert outs["port"] == outs["ref"]
    assert sum(line.startswith(b">")
               for line in outs["port"][0].splitlines()) == 24


def run_both(db, argv, tmp_path):
    """(reference rows, port rows, reference chimera-out ids, port
    chimera-out ids) of one assign command line, -o and --chimera-out
    added."""
    from hmmufotu_tpu.cli.assign import main as ref_main
    from hmmufotu_tpu_torch.cli.assign import main
    res = []
    for tag, fn in (("ref", ref_main),
                    ("port", lambda a: main(a, device="cpu"))):
        out, chi = tmp_path / f"{tag}.tsv", tmp_path / f"{tag}_chi.tsv"
        assert fn([db] + argv + ["-o", str(out), "--chimera-out",
                                 str(chi)]) == 0
        head, rows = read_tsv(out)
        _, chi_rows = read_tsv(chi)
        res.append((head, rows, [r[0] for r in chi_rows]))
    (head_ref, rows_ref, chi_ref), (head, rows, chi) = res
    assert head == head_ref
    return head, rows_ref, rows, chi_ref, chi


def assert_rows_match(head, rows, rows_ref):
    col = {name: i for i, name in enumerate(head)}
    assert [r[0] for r in rows] == [r[0] for r in rows_ref]
    for r, q in zip(rows, rows_ref):
        for name in ("id", "description", "CS_start", "CS_end",
                     "alignment", "branch_id", "taxon_id", "taxon_anno"):
            assert r[col[name]] == q[col[name]], (r[0], name)
        if q[col["taxon_id"]] == "-1":
            continue
        assert float(r[col["branch_ratio"]]) == pytest.approx(
            float(q[col["branch_ratio"]]), abs=BRANCH_ATOL)
        assert float(r[col["loglik"]]) == pytest.approx(
            float(q[col["loglik"]]), rel=LL_RTOL, abs=LL_ATOL)


@pytest.mark.parametrize("mean_size", [400, 600])
def test_pe_assign_matches_reference(dg_db, pairs, tmp_path, mean_size):
    """Inserts of 400 bp, and of 600 bp: merged reads wider than the
    placer's W = 512 columns, of which both packages place the first W."""
    if mean_size != 400:
        from hmmufotu_tpu.cli.sim import main as sim_main
        r1, r2 = str(tmp_path / "w_1.fasta"), str(tmp_path / "w_2.fasta")
        assert sim_main([dg_db, r1, "-m", r2, "-N", str(N_PAIRS), "-S",
                         "8", "--mean-size", str(mean_size), "--sd-size",
                         "20", "-l", "150"]) == 0
        pairs = (r1, r2)
    head, rows_ref, rows, chi_ref, chi = run_both(
        dg_db, list(pairs) + ["-S", "0"], tmp_path)
    assert chi == chi_ref
    assert len(rows) + len(chi) == N_PAIRS
    assert_rows_match(head, rows, rows_ref)
    # the merged reads span both mates: wider than one 150 bp read
    col = {name: i for i, name in enumerate(head)}
    spans = [int(r[col["CS_end"]]) - int(r[col["CS_start"]]) + 1
             for r in rows]
    assert max(spans) > (512 if mean_size > 512 else 300)


@pytest.mark.parametrize("ignore_orient", [False, True],
                         ids=["orient", "ignore-orient"])
def test_pe_swapped_mates(dg_db, pairs, tmp_path, ignore_orient):
    """Pairs whose mates come in the wrong order (the forward read from
    the fragment's 3' end, the mate from its 5' end) are flagged as
    chimeras and go to --chimera-out, in both packages; with
    --ignore-orient they are merged and placed."""
    from hmmufotu_tpu_torch.seq import read_seqs
    from hmmufotu_tpu_torch.alphabet import DNA
    fwd, rev = list(read_seqs(pairs[0])), list(read_seqs(pairs[1]))
    swapped = {1, 4, 9}
    r1, r2 = tmp_path / "sw_1.fasta", tmp_path / "sw_2.fasta"
    with open(r1, "w") as f1, open(r2, "w") as f2:
        for t, (a, b) in enumerate(zip(fwd, rev)):
            s1, s2 = (DNA.revcom(b.seq), DNA.revcom(a.seq)) \
                if t in swapped else (a.seq, b.seq)
            f1.write(f">{a.id} {a.desc}\n{s1}\n")
            f2.write(f">{b.id} {b.desc}\n{s2}\n")
    argv = [str(r1), str(r2), "-S", "0", "-s", "1"]
    if ignore_orient:
        argv.append("--ignore-orient")
    head, rows_ref, rows, chi_ref, chi = run_both(dg_db, argv, tmp_path)
    assert chi == chi_ref
    if ignore_orient:
        assert chi == []
    else:
        assert {fwd[t].id for t in swapped} <= set(chi)
    assert len(rows) + len(chi) == N_PAIRS
    assert_rows_match(head, rows, rows_ref)
