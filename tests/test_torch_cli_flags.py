"""assign's placement and output flags through the port's CLI against
the reference CLI, on a few fixture reads (-S 0, both on the CPU).

Rules, those of PERF.md section 2: the same read ids, alignment columns
equal, and on every row the same branch and taxon with logliks within
1e-4 relative + 0.5 (tests/test_torch_pipeline.py), except a near tie:
a row whose branch differs while both logliks agree within that
tolerance.  At most one near tie a run (of 24 reads) is accepted; the
two packages optimize in f32 with sites summed in different orders, so
candidates whose logliks are closer than that may swap.  With -C the
card only aligns and both packages place each read's segments on the
host in f64, so the rows and the --chimera-out rows are byte-equal.
tests/test_torch_cuda.py holds the card against the CPU by the same
rules."""

import pytest

from test_torch_pipeline import (LL_ATOL, LL_RTOL, db_prefix,  # noqa: F401
                                 one_torch_thread, simulate_reads)

N_READS = 24
MAX_NEAR_TIES = 1


@pytest.fixture(scope="module")
def reads_fa(db_prefix, tmp_path_factory):  # noqa: F811
    from hmmufotu_tpu_torch.db import Database
    reads = simulate_reads(Database.load(db_prefix).ptu, N_READS, seed=4)
    path = tmp_path_factory.mktemp("flags") / "reads.fasta"
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    return str(path)


def rows(path):
    return [line.rstrip("\n").split("\t") for line in open(path)
            if not line.startswith("#") and not line.startswith("id\t")]


FLAG_SETS = [
    ["--opt-k", "4"], ["--ref-rank"], ["--ML"], ["--resident-window", "700"],
    ["--msg-bf16"], ["--align-only"], ["-d", "0.05", "-H", "0.5"],
    ["--prior", "height"], ["-C", "--ref-rank"]]


def flag_id(flags):
    return "".join(flags).lstrip("-")


def run_assign(main, db, reads, flags, out, chi):
    """assign -S 0 -s 1 with `flags` writing `out` (and `chi`, the
    --chimera-out file, under -C); returns their body rows."""
    argv = [db, reads, "-S", "0", "-s", "1"] + flags + ["-o", out]
    if "-C" in flags:
        argv += ["--chimera-out", chi]
    assert main(argv) == 0
    return rows(out), rows(chi) if "-C" in flags else []


def assert_rows_agree(got, want, flags, n_reads=N_READS):
    """got, want: (rows, chimera rows) of two runs with the same flags."""
    (got, got_chi), (want, want_chi) = got, want
    if "-C" in flags:
        assert got == want and got_chi == want_chi
        assert len(got) + len(got_chi) == n_reads
        return
    assert [r[0] for r in got] == [r[0] for r in want]
    assert len(got) == n_reads
    near_ties = 0
    for g, w in zip(got, want):
        assert g[2:10] == w[2:10], g[0]
        assert len(g) == len(w)
        if "--align-only" in flags:
            assert g[10:] == w[10:]
            continue
        if w[10] != "-1":
            assert float(g[15]) == pytest.approx(
                float(w[15]), rel=LL_RTOL, abs=LL_ATOL), g[0]
        if (g[10], g[12], g[13]) != (w[10], w[12], w[13]):
            near_ties += 1
    assert near_ties <= MAX_NEAR_TIES
    if "--align-only" not in flags:
        assert sum(r[10] != "-1" for r in got) >= n_reads - 2


@pytest.mark.parametrize("flags", FLAG_SETS, ids=flag_id)
def test_assign_flags_match_reference(db_prefix, reads_fa,  # noqa: F811
                                      tmp_path, flags):
    from hmmufotu_tpu.cli.assign import main as ref_main
    from hmmufotu_tpu_torch.cli.assign import main
    want = run_assign(ref_main, db_prefix, reads_fa, flags,
                      str(tmp_path / "ref.tsv"), str(tmp_path / "ref_chi.tsv"))
    got = run_assign(lambda a: main(a, device="cpu"), db_prefix, reads_fa,
                     flags, str(tmp_path / "port.tsv"),
                     str(tmp_path / "port_chi.tsv"))
    assert_rows_agree(got, want, flags)
