"""The port's normal entry points at small size (scripts/torch_scale_cli.py:
the build CLI writes the DB files, the assign CLI loads them) against the
reference package's CLIs on the same generated files, and the generator
that chip_smoke.py and the harness share (scripts/evolved_inputs.py).

Rules of tests/test_torch_cli_flags.py (PERF.md section 2): the same read
ids, alignment columns equal, the same branch and taxon with logliks
within 1e-4 relative + 0.5, except a near tie, at most one in 24 reads.
Both packages build with the numpy f64 evaluate engine; the harness runs
its CLIs on the CPU, each in a process of its own."""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_pipeline import LL_ATOL, LL_RTOL, one_torch_thread  # noqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
MAX_NEAR_TIES_PER_24 = 1
# the harness's small shape: 64 evolved leaves x 600 columns, amplicon
# reads of a 400-column region and reads from anywhere
SHAPE = ["--leaves", "64", "--length", "600", "--region", "400",
         "--reads", "48", "--shotgun", "24", "--batch", "24",
         "--parity", "8"]

# sha256 of the files chip_smoke.py's own synth_inputs wrote before it
# moved to scripts/evolved_inputs.py, and of the 16 reads its
# simulate_reads drew from the first tree (rng seed 5)
GENERATOR_SHA256 = {
    (64, 600, 7): {
        "synth.fasta": "dfe6aa8687ae4a7c236c7c96c635c3b2"
                       "4f0c6392c9e334a8c89fffc8c440c1c0",
        "synth.tree": "5494bf4e2de2c72127ab55fef24c2e54"
                      "44d7014aaa4ffca0d61af5b4cd8f9668",
        "synth_taxonomy.txt": "3f8bf356bd34ed52b09bdb631049bab6"
                              "515cceb515af5fb637f1b8998fc52f29"},
    (40, 300, 3): {
        "synth.fasta": "4422e6ed8080d041ed172598f80faa28"
                       "80e1decf9d1ed49f2417095880804e07",
        "synth.tree": "231d5a64bffcabf0ac3fc462dbcf6f73"
                      "03914158625e2e8726e2692f1b1ad89f",
        "synth_taxonomy.txt": "5a8ba3245b6cfb4b5c2229e514f6f9cc"
                              "589882846f0085af29cfde49032b85fa"}}
READS_SHA256 = ("b23f2a8ebeb7b7c78ca507dd2403b891"
                "81226ec25128ea40c21a060a125e147b")


@pytest.fixture(scope="module")
def scripts_path():
    sys.path.insert(0, SCRIPTS)
    yield
    sys.path.remove(SCRIPTS)


def sha256(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


@pytest.mark.parametrize("shape", sorted(GENERATOR_SHA256),
                         ids=lambda s: "x".join(map(str, s)))
def test_generator_writes_the_files_of_the_old_copy(scripts_path, tmp_path,
                                                    shape):
    from evolved_inputs import input_tree, simulate_reads, synth_inputs
    n_leaves, n_cols, seed = shape
    assert synth_inputs(str(tmp_path), n_leaves, n_cols, seed)[0] \
        == 2 * n_leaves - 1
    for name, want in GENERATOR_SHA256[shape].items():
        assert sha256(tmp_path / name) == want, name
    if shape == (64, 600, 7):
        reads = simulate_reads(input_tree(str(tmp_path)),
                               np.random.default_rng(5), 16)
        assert hashlib.sha256("\n".join(reads).encode()).hexdigest() \
            == READS_SHA256


def test_region_reads_come_from_the_region(scripts_path, tmp_path):
    """With region=(lo, hi) every read is a mutated run of one leaf's
    bases in columns [lo, hi)."""
    from evolved_inputs import input_tree, simulate_reads, synth_inputs
    synth_inputs(str(tmp_path), 32, 600, 1)
    tree = input_tree(str(tmp_path))
    lo, hi = 128, 512
    reads = simulate_reads(tree, np.random.default_rng(2), 12, 200,
                           region=(lo, hi))
    leaves = [u for u in range(tree.num_nodes) if tree.msa_id[u] >= 0]
    for read in reads:
        codes = np.array(["ACGT".index(c) for c in read])
        best = 0.0
        for u in leaves:
            pos = np.nonzero(tree.seqs[u] >= 0)[0]
            inside = tree.seqs[u][pos[(pos >= lo) & (pos < hi)]]
            for st in range(len(inside) - len(codes) + 1):
                best = max(best, float(np.mean(
                    inside[st:st + len(codes)] == codes)))
        assert best >= 0.9      # 2% substitutions


def stamps(*rows):
    return [(float(t), m) for t, m in rows]


def test_stage_seconds_and_resident_rule(scripts_path):
    from torch_scale_cli import resident_oow, stage_seconds
    got = stage_seconds(stamps(
        (1, "MSA database created for 4 X 9"), (3, "CSFM index built"),
        (4, "Banded HMM profile trained (K=9)"),
        (8, "DNA substitution model loaded: GTR"),
        (9, "Evaluating phylogenetic tree"),
        (15, "Final tree log-likelihood: -1"),
        (16, "Ancestral sequences inferred"),
        (46, "Database saved with prefix 'x'")))
    assert got == {"msa_prune": 1, "csfm": 2, "hmm": 1,
                   "newick_annotate_heights": 4, "evaluate": 7,
                   "infer_seq": 1, "save": 30}
    # -V: the alpha estimate and the second evaluate on their own
    from torch_scale_cli import EVALUATED, GAMMA_STAGES
    got = stage_seconds(stamps(
        (1, "MSA database created for 4 X 9"), (3, "CSFM index built"),
        (4, "Banded HMM profile trained (K=9)"),
        (8, "DNA substitution model loaded: GTR"),
        (9, "Evaluating phylogenetic tree"), (12, EVALUATED + " 1"),
        (13, "Estimated dGamma alpha = 0.5"), (20, EVALUATED + " 2"),
        (21, "Final tree log-likelihood: -1"),
        (22, "Ancestral sequences inferred"),
        (52, "Database saved with prefix 'x'")), GAMMA_STAGES)
    assert got == {"msa_prune": 1, "csfm": 2, "hmm": 1,
                   "newick_annotate_heights": 4, "evaluate": 4,
                   "alpha_estimate": 1, "evaluate_dgamma": 8,
                   "infer_seq": 1, "save": 30}

    def row(cs_start, cs_end, cost="10"):
        return ["r", "d", "1", "9", "1", "9", str(cs_start), str(cs_end),
                cost, "ACGT"]

    # the window starts at the first reads' lowest start, on a 128-column
    # boundary: [1,536, 2,560) of 6,000 columns
    rows = [row(1600, 1900), row(1540, 1800), row(2000, 2600),
            row(1500, 1700), row(0, 0, "inf")]
    got = resident_oow(rows, 6000, sample=2)
    assert got["site_window"] == [1536, 1024]
    # 2000-2600 covers [1999, 2510]: inside; 1500 starts before the window
    assert got["reads_aligned"] == 4 and got["reads_out_of_window"] == 1
    got = resident_oow([row(1600, 2400), row(2100, 2700)], 6000)
    # the window is [1536, 2560): 2099 + 511 = 2610 leaves it
    assert got["reads_out_of_window"] == 1 and got["share"] == 0.5


def tsv_rows(path):
    return [line.rstrip("\n").split("\t") for line in open(path)
            if not line.startswith("#") and not line.startswith("id\t")]


def assert_tsv_agree(got, want):
    """The rules of tests/test_torch_cli_flags.py on two assignment
    TSVs."""
    assert [r[0] for r in got] == [r[0] for r in want] and got
    near_ties = 0
    for g, w in zip(got, want):
        assert g[2:10] == w[2:10], g[0]
        assert len(g) == len(w)
        if w[10] != "-1":
            assert float(g[15]) == pytest.approx(
                float(w[15]), rel=LL_RTOL, abs=LL_ATOL), g[0]
        if (g[10], g[12], g[13]) != (w[10], w[12], w[13]):
            near_ties += 1
    assert near_ties <= MAX_NEAR_TIES_PER_24 * len(want) / 24
    assert sum(r[10] != "-1" for r in got) >= len(got) - 2


@pytest.mark.parametrize("flags", [[], ["--gamma"]],
                         ids=["gtr", "gamma"])
def test_scale_cli_matches_reference_clis(tmp_path, flags):
    """The harness's build and assign CLIs (numpy engine, on the CPU)
    against the reference package's CLIs on the same inputs and read
    files; with --gamma (BASELINE config #3's path) both build -V -k 4."""
    from hmmufotu_tpu.cli.assign import main as ref_assign
    from hmmufotu_tpu.cli.build import main as ref_build
    from hmmufotu_tpu.db import Database as RefDB
    gamma = bool(flags)
    work = tmp_path / "port"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "torch_scale_cli.py")]
        + SHAPE + flags + ["--eval-engine", "numpy", "--device", "cpu",
                           "--work", str(work), "--progress",
                           str(tmp_path / "p.json")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert json.load(open(tmp_path / "p.json")) == got
    assert got["device"] == "cpu" and got["card"] is None
    assert got["n_nodes"] == 127 and got["gamma"] == gamma
    # config #3's reads and parity are cuts only of a --gamma run
    assert got["reduced"]["to"] == (
        "127 nodes; 48 reads; 8 parity" if gamma else "127 nodes")
    b = got["build"]
    stages = ({"evaluate", "alpha_estimate", "evaluate_dgamma"} if gamma
              else {"evaluate"})
    assert b["rc"] == 0 and set(b["stages_s"]) == {
        "msa_prune", "csfm", "hmm", "newick_annotate_heights",
        "infer_seq", "save"} | stages
    assert set(b["file_bytes"]) == {".msa.npz", ".csfm.npz", ".hmm",
                                    ".ptu.npz"}
    assert set(b["clocks"]) == {"save" + s for s in b["file_bytes"]} \
        | {"evaluate_s"}
    for name, n in (("amplicon", 48), ("shotgun", 24)):
        a = got[name]
        assert a["rc"] == 0 and a["reads"] == n == a["tsv_rows"]
        assert set(a["clocks"]) == {"load_s", "upload_s", "stream_s"}
        # Database.load by file, the .ptu.npz by member
        files, members = a["load_files_s"], a["load_ptu_members_s"]
        assert set(files) == set(b["file_bytes"])
        assert set(members) == {"msg_up", "msg_down", "rest"}
        assert sum(files.values()) <= a["clocks"]["load_s"]
        assert sum(members.values()) <= files[".ptu.npz"]
        assert a["npz_threads"] == b["npz_threads"] > 0
        assert [p[1] for p in a["processed"]] == list(range(24, n + 1, 24))
        assert a["parity_rows"] == a["parity_tsv_rows_equal"] == 8
        assert a["parity_cnode_match"] >= 0.95 * a["parity_reads"] > 0
        assert a["parity_loglik_match"] >= 0.95 * a["parity_reads"]
        assert a["out_of_window"]["reads_aligned"] == n
        assert a["peak_rss_gb"] > 0 and a["device_peak_gb"] is None
        assert a["msg_dtype"] == "float32" and a["tsv_bytes"] > 0
        assert a["placer_rates"] == (4 if gamma else 1)
        assert (a["dg_alpha"] is None) != gamma
    # the reference package's CLIs on the same files
    ref = str(tmp_path / "ref")
    assert ref_build([str(work / "synth.fasta"), str(work / "synth.tree"),
                      "-a", str(work / "synth_taxonomy.txt"), "-n", ref,
                      "-s", "GTR", "--msg-dtype", "f32",
                      "--eval-engine", "numpy"]
                     + (["-V", "-k", "4"] if gamma else [])) == 0
    dg = RefDB.load(ref).ptu.dg
    assert (dg is None) != gamma
    if gamma:
        # the build's log line holds %g of the alpha
        assert b["dg_alpha"] == pytest.approx(dg.alpha, rel=1e-5)
        assert got["amplicon"]["dg_alpha"] == dg.alpha
    for name in ("amplicon", "shotgun"):
        want = str(tmp_path / f"{name}.tsv")
        assert ref_assign([ref, str(work / f"{name}.fasta"), "-o", want,
                           "-b", "24"]) == 0
        assert_tsv_agree(tsv_rows(work / f"{name}.tsv"), tsv_rows(want))
