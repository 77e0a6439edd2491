"""The port's inspect, train_hmm, train_sm, train_dm and anneal CLIs
against the reference package's on the 70_otus fixture: the same files
and the same standard output, byte for byte.

inspect and the trainers are host code on the same numpy functions in
both packages.  anneal aligns the primers on the device; the port runs
its aligner on the CPU here, whose alignments equal the reference's
(tests/test_torch_viterbi.py), so its rows are byte-equal too.  The one
line left out of the comparison is the HMMER file's DATE, the clock
time of the write."""

import os

import pytest

from test_torch_pipeline import db_prefix, one_torch_thread  # noqa: F401

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
MSA_F = os.path.join(FIX, "70_otus.fasta")
TREE_F = os.path.join(FIX, "70_otus.tree")


def run_both(name, argv_of, tmp_path, capsys, port_kw=None):
    """Run cli.<name>.main of both packages with argv_of(tag); returns
    {tag: (stdout, {file name: bytes})} of the files each run wrote
    into its own directory."""
    import importlib
    got = {}
    for tag, pkg in (("ref", "hmmufotu_tpu"), ("port", "hmmufotu_tpu_torch")):
        d = tmp_path / tag
        d.mkdir()
        main = importlib.import_module(f"{pkg}.cli.{name}").main
        kw = port_kw if tag == "port" and port_kw else {}
        assert main(argv_of(d), **kw) == 0
        files = {p.name: without_date(p.read_bytes())
                 for p in sorted(d.iterdir())}
        got[tag] = (capsys.readouterr().out, files)
    return got


def without_date(text: bytes) -> bytes:
    return b"".join(line for line in text.splitlines(keepends=True)
                    if not line.startswith(b"DATE "))


def small_msa(path, n_seqs=30, width=300):
    """The first n_seqs sequences of the fixture cut to `width` columns.
    The trainers' optimizers take minutes on the whole fixture and on
    some slices of it (20 x 400: two minutes for the transition
    densities); on this one each package takes about 12 s."""
    seqs, cur = [], None
    for line in open(MSA_F):
        if line.startswith(">"):
            if len(seqs) >= n_seqs:
                break
            cur = [line.strip()]
            seqs.append(cur)
        else:
            cur.append(line.strip())
    path.write_text("\n".join(
        s[0] + "\n" + "".join(s[1:])[:width] for s in seqs) + "\n")
    return str(path)


@pytest.mark.parametrize("flags", [[], ["--sm", "--dg", "-l", "-p", "n"]],
                         ids=["stats", "exports"])
def test_inspect_matches_reference(db_prefix, tmp_path, capsys,  # noqa: F811
                                   flags):
    got = run_both("inspect", lambda d: [
        db_prefix, "-t", str(d / "t.nwk"), "-a", str(d / "a.tsv"),
        "-s", str(d / "s.fasta")] + flags, tmp_path, capsys)
    assert got["port"] == got["ref"]
    out, files = got["port"]
    assert "tree log-likelihood" in out
    assert set(files) == {"t.nwk", "a.tsv", "s.fasta"}


def test_train_hmm_matches_reference(tmp_path, capsys):
    got = run_both("train_hmm", lambda d: [MSA_F, "-o", str(d / "t.hmm")],
                   tmp_path, capsys)
    assert got["port"] == got["ref"]
    assert got["port"][1]["t.hmm"].startswith(b"HMMER3/f")


@pytest.mark.parametrize("model", ["GTR", "HKY85"])
def test_train_sm_matches_reference(tmp_path, capsys, model):
    got = run_both("train_sm", lambda d: [
        MSA_F, TREE_F, "-o", str(d / "t.sm"), "-s", model],
        tmp_path, capsys)
    assert got["port"] == got["ref"]
    assert model.encode() in got["port"][1]["t.sm"]


def test_train_dm_matches_reference(tmp_path, capsys):
    msa = small_msa(tmp_path / "small.fasta")
    got = run_both("train_dm", lambda d: [
        msa, "-o", str(d / "t.dm"), "-n", "1", "-S", "0"], tmp_path, capsys)
    assert got["port"] == got["ref"]
    assert got["port"][1]["t.dm"]


def test_anneal_matches_reference(db_prefix, tmp_path, capsys):  # noqa: F811
    primers = tmp_path / "primers.fasta"
    # 515F / 806R-style primers with IUPAC degeneracies
    primers.write_text(">515F\nGTGYCAGCMGCCGCGGTAA\n"
                       ">806R\nGGACTACNVGGGTWTCTAAT\n")
    got = run_both("anneal", lambda d: [
        db_prefix, str(primers), "-o", str(d / "anneal.tsv")],
        tmp_path, capsys, port_kw=dict(device="cpu"))
    assert got["port"] == got["ref"]
    rows = got["port"][1]["anneal.tsv"].decode().splitlines()
    assert len(rows) == 3 and rows[0].startswith("id\t")
