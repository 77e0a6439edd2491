"""BASELINE config #5's harness (scripts/torch_scale_sum.py: assign once
a sample, sum once a host, merge) at small size on the CPU, against the
reference package's sum and merge CLIs on the harness's own TSVs and DB;
its independent-count gate; its community sampler; and the sum and merge
runs of scripts/torch_scale_cli.py's child runner.

The tools are host code in both packages, so their outputs are byte-equal
on the same inputs, the '#' header lines (program name and command) aside.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from test_torch_pipeline import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
# the harness's small shape: 64 evolved leaves x 600 columns, 3 samples
# of 48 amplicon reads of a 400-column region
SHAPE = ["--leaves", "64", "--length", "600", "--region", "400",
         "--samples", "3", "--sample-reads", "48", "--batch", "24",
         "--parity", "8"]
SUM_CLOCKS = {"load_s", "parse_s", "encode_s", "accumulate_s", "table_s",
              "consensus_s", "tree_s"}
MERGE_CLOCKS = {"load_s", "tables_load_s", "tables_add_s", "tree_s"}


@pytest.fixture(scope="module")
def scripts_path():
    sys.path.insert(0, SCRIPTS)
    yield
    sys.path.remove(SCRIPTS)


def env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """One run of the harness on the CPU: (its JSON line, work dir)."""
    tmp = tmp_path_factory.mktemp("scale_sum")
    work = tmp / "work"
    out = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "torch_scale_sum.py")]
        + SHAPE + ["--eval-engine", "numpy", "--device", "cpu", "--work",
                   str(work), "--progress", str(tmp / "p.json")],
        env=env(), cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert json.load(open(tmp / "p.json")) == got
    return got, work


def body(path):
    """A text output's bytes without its '#' header lines."""
    with open(path, "rb") as fh:
        return b"".join(line for line in fh if not line.startswith(b"#"))


def with_outputs(argv, outputs, d):
    """argv with each output path moved into directory d."""
    moved = {p: os.path.join(d, os.path.basename(p))
             for p in outputs.values()}
    return [moved.get(a, a) for a in argv], moved


def test_harness_runs_and_matches_reference_clis(harness, tmp_path):
    """rc 0, the JSON's keys, every gate passed; the reference package's
    sum and merge on the harness's TSVs and DB write the same tables,
    read lists, consensus FASTAs and newicks."""
    from hmmufotu_tpu.cli.merge import main as ref_merge
    from hmmufotu_tpu.cli.sum import main as ref_sum
    got, work = harness
    for key in ("samples", "reads_per_sample", "t_sum_s", "t_merge_s",
                "merged_otus", "merged_total_reads", "rows_expected",
                "peak_rss_gb", "reduced", "card", "free_total_gb",
                "load_share", "t_loads_s", "build", "assign", "sum",
                "merge", "gates"):
        assert key in got, key
    assert got["device"] == "cpu" and got["card"] is None
    assert got["samples"] == 3 and got["reads_per_sample"] == 48
    assert got["rows_expected"] == 144 and got["n_nodes"] == 127
    assert got["reduced"] == {
        "what": "leaves; reads a sample",
        "from": "149,999 nodes; 100M+ reads", "to": "127 nodes; 3 x 48",
        "why": "3 x 48 reads fit one chip call with the build and every "
               "load; the two hosts' merge is emulated on one machine (two "
               "sums, then merge): neither package has a collective on a "
               "CLI path"}
    # a quarter of the leaves shared, a quarter each sample's own
    k = got["community_leaves"][0] // 2
    assert 12 <= k <= 16 and got["community_leaves"] == [2 * k] * 3
    assert got["distinct_leaves"] == k + 3 * k
    g = got["gates"]
    assert g["ok"] and g["fails"] == [] and g["count"]["ok"]
    assert g["rows"] == {"s0": 48, "s1": 48, "s2": 48}
    assert got["merged_total_reads"] == g["count"]["assigned_rows"] > 0
    assert got["merged_otus"] == g["count"]["merged_otus"] > 0
    assert all(c["ok"] for c in g["consensus"].values()) and g["newick"]["ok"]
    for s, a in enumerate(got["assign"]):
        assert a["rc"] == 0 and a["sample"] == f"s{s}"
        assert set(a["clocks"]) == {"load_s", "upload_s", "stream_s"}
        assert [p[1] for p in a["processed"]] == [24, 48]
        assert a["tsv_bytes"] > 0 and "launches" not in a
        assert ("parity_reads" in a) == (s == 0)
    a0 = got["assign"][0]
    assert a0["parity_cnode_match"] >= 0.95 * a0["parity_reads"] > 0
    assert a0["parity_loglik_match"] >= 0.95 * a0["parity_reads"]
    assert set(got["build"]["stages_s"]) == {
        "msa_prune", "csfm", "hmm", "newick_annotate_heights", "evaluate",
        "infer_seq", "save"}
    for r in got["sum"].values():
        assert r["rc"] == 0 and set(r["clocks"]) == SUM_CLOCKS
        assert r["otus"] > 0 and r["loop_s"] > 0
    assert got["merge"]["rc"] == 0
    assert set(got["merge"]["clocks"]) == MERGE_CLOCKS
    # the reference package's CLIs, the same command lines
    for fn, run in [(ref_sum, got["sum"]["A"]), (ref_sum, got["sum"]["B"]),
                    (ref_merge, got["merge"])]:
        argv, moved = with_outputs(run["argv"], run["outputs"],
                                   str(tmp_path))
        assert fn(argv) == 0
        for ours, theirs in moved.items():
            assert body(ours) == body(theirs), ours
            assert len(body(ours)) > 0


DB_FILES = {".msa.npz", ".csfm.npz", ".hmm", ".ptu.npz"}


def test_load_clocks_by_file_and_member(harness):
    """Each assign and sum run clocks Database.load by file and the
    .ptu.npz by member, each sum within the clock around it; merge -t
    reads the .ptu.npz's topology members alone; every run names the
    npz threads."""
    got, _ = harness
    for r in got["assign"] + list(got["sum"].values()):
        files, members = r["load_files_s"], r["load_ptu_members_s"]
        assert set(files) == DB_FILES
        assert set(members) == {"msg_up", "msg_down", "rest"}
        assert all(v >= 0 for v in list(files.values())
                   + list(members.values()))
        assert sum(files.values()) <= r["clocks"]["load_s"]
        assert sum(members.values()) <= files[".ptu.npz"]
        assert r["npz_threads"] == len(os.sched_getaffinity(0))
    m = got["merge"]
    assert m["load_files_s"] == {}
    assert sorted(m["ptu_members_read"]) == ["brlen", "meta", "parent"]
    assert set(m["load_ptu_members_s"]) == {"rest"}
    assert m["load_ptu_members_s"]["rest"] <= m["clocks"]["load_s"]


def test_reuse_db_skips_the_build(harness, tmp_path):
    """--reuse-db on a copy of the work directory: no build, and the same
    merged table and OTU tree."""
    got, work = harness
    copy = tmp_path / "work"
    shutil.copytree(work, copy)
    out = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "torch_scale_sum.py")]
        + SHAPE + ["--eval-engine", "numpy", "--device", "cpu", "--work",
                   str(copy), "--reuse-db"],
        env=env(), cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    again = json.loads(out.stdout.strip().splitlines()[-1])
    assert again["build"]["reused"] and "wall_s" not in again["build"]
    assert again["build"]["file_bytes"] == got["build"]["file_bytes"]
    assert again["gates"]["ok"]
    for name in ("merged.tsv", "merged.nwk", "A.tsv", "B_reads.tsv"):
        assert body(copy / name) == body(work / name), name


@pytest.mark.parametrize("fault", ["intact", "count_changed", "otu_dropped",
                                   "otu_added", "rows_short"])
def test_gates_bite(scripts_path, harness, tmp_path, fault):
    """The gates pass the harness's outputs and fail a merged table with
    a count changed, an OTU dropped or an OTU added (the independent
    count), or a sample TSV short of its reads."""
    from torch_scale_sum import otu_gates
    got, work = harness
    tsvs = {f"s{s}": str(work / f"s{s}.tsv") for s in range(3)}
    rows = dict.fromkeys(tsvs, 48 + (fault == "rows_short"))
    lines = open(work / "merged.tsv").read().splitlines(keepends=True)
    first = next(i for i, x in enumerate(lines)
                 if x.startswith("OTU_"))
    if fault == "count_changed":
        f = lines[first].split("\t")
        f[1] = str(int(f[1]) + 1)
        lines[first] = "\t".join(f)
    elif fault == "otu_dropped":
        del lines[first]
    elif fault == "otu_added":
        lines.append("OTU_999999\t0\t0\t0\tk__X\n")
    merged = tmp_path / "merged.tsv"
    merged.write_text("".join(lines))
    gates = otu_gates(tsvs, rows, {h: r["outputs"]
                                   for h, r in got["sum"].items()},
                      str(merged), str(work / "merged.nwk"), 600)
    assert gates["ok"] == (fault == "intact"), gates
    assert gates["count"]["ok"] == (fault in ("intact", "rows_short"))
    # the OTU tree does not name an OTU the merge never wrote
    assert gates["newick"]["ok"] == (fault != "otu_added")
    assert all(g["ok"] for g in gates["consensus"].values())


@pytest.fixture(scope="module")
def sampler_tree(scripts_path, tmp_path_factory):
    """An evolved tree of 4,096 leaves x 400 columns: room for communities
    of 1,000 + 1,000 leaves in 3 samples."""
    from evolved_inputs import input_tree, synth_inputs
    d = str(tmp_path_factory.mktemp("sampler"))
    synth_inputs(d, 4096, 400, 3)
    return input_tree(d)


def test_communities(sampler_tree):
    """Deterministic by seed; each sample exactly its 1,000 + 1,000
    leaves, all real leaves of the tree; the shared ones the same in
    every sample, the own ones of no other sample."""
    from torch_scale_sum import communities
    tree = sampler_tree
    region = (0, tree.cs_len)
    comm = communities(tree, 3, 1000, 1000, 10, region)
    again = communities(tree, 3, 1000, 1000, 10, region)
    other = communities(tree, 3, 1000, 1000, 11, region)
    assert all(np.array_equal(a, b) for a, b in zip(comm, again))
    assert not np.array_equal(comm[0], other[0])
    own = []
    for c in comm:
        assert len(c) == 2000 and len(set(c.tolist())) == 2000
        assert all(tree.is_leaf(int(u)) and tree.msa_id[u] >= 0 for u in c)
        assert np.array_equal(c[:1000], comm[0][:1000])
        own.append(set(c[1000:].tolist()))
    shared = set(comm[0][:1000].tolist())
    assert not (own[0] & own[1]) and not (own[1] & own[2]) \
        and not (own[0] & own[2])
    assert not any(shared & o for o in own)
    with pytest.raises(ValueError):
        communities(tree, 3, 1000, 1100, 10, region)


def test_sample_reads_come_from_the_region(sampler_tree):
    """Deterministic by (seed, sample); every read is a mutated run of
    its source leaf's bases in the region, and the source leaves are the
    community's."""
    from torch_scale_sum import communities, sample_reads
    tree = sampler_tree
    lo, hi = 40, 400
    comm = communities(tree, 2, 4, 4, 5, (lo, hi))
    reads, src = sample_reads(tree, comm[1], 24, 5, 1, (lo, hi))
    again, src2 = sample_reads(tree, comm[1], 24, 5, 1, (lo, hi))
    other, _ = sample_reads(tree, comm[1], 24, 5, 0, (lo, hi))
    assert reads == again and np.array_equal(src, src2) and reads != other
    assert len(reads) == 24 and set(src.tolist()) <= set(comm[1].tolist())
    for read, u in zip(reads, src.tolist()):
        codes = np.array(["ACGT".index(c) for c in read])
        pos = np.nonzero(tree.seqs[u] >= 0)[0]
        inside = tree.seqs[u][pos[(pos >= lo) & (pos < hi)]]
        best = max(float(np.mean(inside[st:st + len(codes)] == codes))
                   for st in range(len(inside) - len(codes) + 1))
        assert best >= 0.9      # 2% substitutions


def test_stream_rates(scripts_path):
    """The first batch's seconds from the stream's start, reads/s over
    the first and the last k batches between Processed lines."""
    from torch_scale_sum import stream_rates
    # batch 1 ends at 3 s (the stream started at 1 s), then 10 reads/s,
    # then 5 reads/s over the last two full batches, then a short batch
    processed = [[3.0, 10], [4.0, 20], [5.0, 30], [7.0, 40], [9.0, 50]]
    want = {"batches": 2, "first_batch_s": 2.0, "first_reads_per_s": 10.0,
            "last_reads_per_s": 5.0, "last_over_first": 0.5}
    assert stream_rates(processed, 8.0, k=2) == want
    assert stream_rates(processed + [[9.1, 54]], 8.1, k=2) == want
    assert stream_rates(processed, 8.0)["batches"] == 2
    assert stream_rates(processed[:2], 3.0) is None


def test_loop_seconds(scripts_path):
    """From the first sample's line to the table's."""
    from torch_scale_sum import loop_seconds
    assert loop_seconds([(1.0, "Database loaded"),
                         (2.5, "Processing sample s0 ..."),
                         (4.0, "Processing sample s1 ..."),
                         (7.0, "Computing OTUTable")]) == 4.5
    assert loop_seconds([(1.0, "Processing sample s0 ...")]) is None


@pytest.mark.parametrize("cli", ["sum", "merge"])
def test_child_runs_print_clocks_and_keep_outputs(harness, tmp_path, cli):
    """torch_scale_cli.py's child runs sum and merge with their clocks;
    the files it writes are byte-equal, headers included, to those of a
    direct call of the port's CLI with the same command line."""
    from hmmufotu_tpu_torch.cli.merge import main as merge_main
    from hmmufotu_tpu_torch.cli.sum import main as sum_main
    got, _ = harness
    run = got["sum"]["A"] if cli == "sum" else got["merge"]
    argv, moved = with_outputs(run["argv"], run["outputs"], str(tmp_path))
    assert (sum_main if cli == "sum" else merge_main)(list(argv)) == 0
    direct = {p: open(p, "rb").read() for p in moved.values()}
    for p in moved.values():
        os.unlink(p)
    spec = {"cli": cli, "argv": argv, "device": "cpu", "parity": 0,
            "tsv": ""}
    out = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "torch_scale_cli.py"),
         "--child", json.dumps(spec)], env=env(), cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["rc"] == 0 and line["peak_rss_gb"] > 0
    assert line["device_peak_gb"] is None
    assert set(line["clocks"]) == (SUM_CLOCKS if cli == "sum"
                                   else MERGE_CLOCKS)
    assert all(v >= 0 for v in line["clocks"].values())
    assert any(m.startswith("Merged table" if cli == "merge"
                            else "OTU table written")
               for _, m in line["stamps"])
    for p, want in direct.items():
        assert open(p, "rb").read() == want, p
