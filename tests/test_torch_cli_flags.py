"""assign's placement and output flags through the port's CLI against
the reference CLI, on a few fixture reads (-S 0, both on the CPU).

Rules, those of PERF.md section 2: the same read ids, alignment columns
equal, and on every row the same branch and taxon with logliks within
1e-4 relative + 0.5 (tests/test_torch_pipeline.py), except a near tie:
a row whose branch differs while both logliks agree within that
tolerance.  At most one near tie a run (of 24 reads) is accepted; the
two packages optimize in f32 with sites summed in different orders, so
candidates whose logliks are closer than that may swap."""

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


@pytest.mark.parametrize("flags", [
    ["--opt-k", "4"], ["--ref-rank"], ["--ML"], ["--resident-window", "700"],
    ["--msg-bf16"], ["--align-only"], ["-d", "0.05", "-H", "0.5"],
    ["--prior", "height"]], ids=lambda f: "".join(f).lstrip("-"))
def test_assign_flags_match_reference(db_prefix, reads_fa,  # noqa: F811
                                      tmp_path, flags):
    from hmmufotu_tpu.cli.assign import main as ref_main
    from hmmufotu_tpu_torch.cli.assign import main
    argv = [db_prefix, reads_fa, "-S", "0", "-s", "1"] + flags
    ref, port = str(tmp_path / "ref.tsv"), str(tmp_path / "port.tsv")
    assert ref_main(argv + ["-o", ref]) == 0
    assert main(argv + ["-o", port], device="cpu") == 0
    got, want = rows(port), rows(ref)
    assert [r[0] for r in got] == [r[0] for r in want]
    assert len(got) == N_READS
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
        assert sum(r[10] != "-1" for r in got) >= N_READS - 2
