"""The port's tools around assign on the CPU: --resume, and sum, jplace,
subset, norm and merge against the reference package's CLIs on one
assignment TSV of the 70_otus fixture DB.

The tools are host code in both packages.  Each pair of runs takes the
same command line (the second run writes over the first's output), so
their outputs are byte-equal, header lines included."""

import pytest

from test_torch_pipeline import db_prefix, one_torch_thread  # noqa: F401

N_READS = 30


@pytest.fixture(scope="module")
def sim_reads(db_prefix, tmp_path_factory):  # noqa: F811
    from hmmufotu_tpu_torch.cli.sim import main as sim_main
    out = str(tmp_path_factory.mktemp("sim") / "sim_SE.fasta")
    assert sim_main([db_prefix, out, "-N", str(N_READS), "-S", "0",
                     "--mean-size", "300", "--sd-size", "20"]) == 0
    return out


@pytest.fixture(scope="module")
def pairs(db_prefix, tmp_path_factory):  # noqa: F811
    from hmmufotu_tpu_torch.cli.sim import main as sim_main
    d = tmp_path_factory.mktemp("pe")
    r1, r2 = str(d / "pe_1.fasta"), str(d / "pe_2.fasta")
    assert sim_main([db_prefix, r1, "-m", r2, "-N", "12", "-S", "2",
                     "--mean-size", "400", "--sd-size", "20",
                     "-l", "150"]) == 0
    return r1, r2


@pytest.fixture(scope="module")
def assignment(db_prefix, sim_reads, tmp_path_factory):  # noqa: F811
    """The reference CLI's assignment TSV of the simulated reads."""
    from hmmufotu_tpu.cli.assign import main as ref_main
    out = str(tmp_path_factory.mktemp("assign") / "assign.tsv")
    assert ref_main([db_prefix, sim_reads, "-o", out, "-S", "0"]) == 0
    return out


def body_ids(path):
    return [line.split("\t")[0] for line in open(path)
            if not line.startswith("#") and not line.startswith("id\t")]


@pytest.mark.parametrize("path", ["stream", "paired"])
def test_assign_resume_appends(db_prefix, sim_reads, pairs,  # noqa: F811
                               tmp_path, path):
    """--resume skips the ids already in the output and appends the rest
    without a second header, on the stream path (single-end) and on the
    batch loop (paired-end): the ids of a full run, each once."""
    from hmmufotu_tpu_torch.cli.assign import main
    reads = [sim_reads] if path == "stream" else list(pairs)
    full, part = str(tmp_path / "full.tsv"), str(tmp_path / "part.tsv")
    assert main([db_prefix] + reads + ["-o", full, "-S", "5"],
                device="cpu") == 0
    lines = open(full).readlines()
    head = [line for line in lines
            if line.startswith("#") or line.startswith("id\t")]
    body = [line for line in lines if line not in head]
    with open(part, "w") as fh:
        fh.writelines(head + body[:5])
    assert main([db_prefix] + reads + ["-o", part, "-S", "5", "--resume"],
                device="cpu") == 0
    got = open(part).readlines()
    assert got[:len(head)] == head
    assert sum(line.startswith("id\t") for line in got) == 1
    assert sorted(body_ids(part)) == sorted(body_ids(full))
    assert len(body_ids(part)) == len(set(body_ids(part)))


def run_pair(ref_fn, fn, argv, outs):
    """Run the reference tool and the port's with one command line;
    return the bytes of each output file, reference's then port's."""
    res = []
    for f in (ref_fn, fn):
        assert f(list(argv)) == 0
        res.append([open(o, "rb").read() for o in outs])
    return res


def test_sum_matches_reference(db_prefix, assignment, tmp_path):  # noqa: F811
    from hmmufotu_tpu.cli.sum import main as ref_sum
    from hmmufotu_tpu_torch.cli.sum import main as port_sum
    outs = [str(tmp_path / n) for n in ("otu.tsv", "reads.txt",
                                        "otus.fasta", "otus.tree",
                                        "otus.ptree")]
    argv = [db_prefix, assignment, assignment, "-s", "a", "b",
            "-o", outs[0], "-l", outs[1], "-c", outs[2], "-t", outs[3],
            "-pt", outs[4], "-q", "1"]
    ref, port = run_pair(ref_sum, port_sum, argv, outs)
    assert port == ref
    assert ref[0].count(b"\nOTU_") > 0 and ref[2].startswith(b">OTU_")


@pytest.mark.parametrize("opts", [[], ["--sm", "--anno", "-q", "5"]],
                         ids=["plain", "sm-anno-q"])
def test_jplace_matches_reference(db_prefix, assignment, tmp_path,  # noqa: F811
                                  opts):
    from hmmufotu_tpu.cli.jplace import main as ref_jplace
    from hmmufotu_tpu_torch.cli.jplace import main as port_jplace
    out = str(tmp_path / "a.jplace")
    ref, port = run_pair(ref_jplace, port_jplace,
                         [db_prefix, assignment, "-o", out] + opts, [out])
    assert port == ref
    assert b'"placements"' in ref[0]


@pytest.fixture(scope="module")
def otu_table(db_prefix, assignment, tmp_path_factory):  # noqa: F811
    from hmmufotu_tpu.cli.sum import main as ref_sum
    out = str(tmp_path_factory.mktemp("otu") / "otu.tsv")
    assert ref_sum([db_prefix, assignment, "-o", out]) == 0
    return out


@pytest.mark.parametrize("method", ["uniform", "multinomial"])
def test_subset_matches_reference(otu_table, tmp_path, method):
    from hmmufotu_tpu.cli.subset import main as ref_subset
    from hmmufotu_tpu_torch.cli.subset import main as port_subset
    out = str(tmp_path / "sub.tsv")
    ref, port = run_pair(ref_subset, port_subset,
                         [otu_table, out, "-n", "10", "-m", method, "-S",
                          "4", "--prune-otus"], [out])
    assert port == ref


@pytest.mark.parametrize("z", ["0", "1", "1000"])
def test_norm_matches_reference(otu_table, tmp_path, z):
    from hmmufotu_tpu.cli.norm import main as ref_norm
    from hmmufotu_tpu_torch.cli.norm import main as port_norm
    out = str(tmp_path / "norm.tsv")
    ref, port = run_pair(ref_norm, port_norm, [otu_table, out, "-Z", z],
                         [out])
    assert port == ref


def test_merge_matches_reference(db_prefix, otu_table, tmp_path):  # noqa: F811
    from hmmufotu_tpu.cli.merge import main as ref_merge
    from hmmufotu_tpu.cli.subset import main as ref_subset
    from hmmufotu_tpu_torch.cli.merge import main as port_merge
    sub = str(tmp_path / "sub.tsv")
    assert ref_subset([otu_table, sub, "-n", "10", "-S", "1"]) == 0
    out, tree = str(tmp_path / "merged.tsv"), str(tmp_path / "merged.tree")
    ref, port = run_pair(ref_merge, port_merge,
                         [otu_table, sub, "-o", out, "-db", db_prefix,
                          "-t", tree], [out, tree])
    assert port == ref
    assert ref[1].endswith(b";")
