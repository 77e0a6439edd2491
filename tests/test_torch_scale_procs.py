"""scripts/torch_scale_procs.py (`assign --num-processes N` through the
port's CLIs, N processes against one) at a tiny shape on the CPU, the
gathered rows against the reference package's assign CLI on the same DB
files, and the harness's arithmetic on hand-made numbers.

The reference CLI computes the placements in f32 in another order, so
its rows are held by the rules of tests/test_torch_cli_flags.py (the
same ids and alignment columns byte for byte; the same branch and taxon
with logliks within 1e-4 relative + 0.5, except a near tie, at most one
in 24 reads); the N-process rows are held byte-equal to one process's."""

import json
import os
import subprocess
import sys

import pytest

from test_torch_scale_cli import assert_tsv_agree, tsv_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
SHAPE = ["--leaves", "64", "--length", "600", "--reads", "256",
         "--pairs", "64", "--processes", "1,2", "--eval-engine", "numpy",
         "--device", "cpu", "--parity", "32"]
PER_PROCESS = {"rc", "exit", "wall_s", "clocks", "load_files_s",
               "load_ptu_members_s", "peak_rss_gb", "device_peak_gb",
               "cpu_s", "stream_cpu_s", "torch_threads", "npz_threads",
               "cards_seen", "stream_stages_s", "viterbi_timing_s",
               "aborted", "abort_after_rows", "abort_lines", "processed"}
PER_N = {"processes", "reads", "stream_s", "stream_gather_s", "wall_s",
         "reads_per_s_stream",
         "reads_per_s_wall", "efficiency_stream", "efficiency_wall",
         "cpu_s", "align_out", "rows"}


@pytest.fixture(scope="module")
def scripts_path():
    sys.path.insert(0, SCRIPTS)
    yield
    sys.path.remove(SCRIPTS)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """One CPU run of the harness at the tiny shape: its JSON line and
    work directory."""
    work = tmp_path_factory.mktemp("procs")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "torch_scale_procs.py")]
        + SHAPE + ["--work", str(work), "--progress",
                   str(work / "p.json")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert json.load(open(work / "p.json")) == got
    return got, work


def test_harness_result(harness):
    got, _ = harness
    assert got["device"] == "cpu" and got["card"] is None
    assert got["cards"] == 0 and got["nproc"] > 0
    assert got["free_total_gb"] > 0 and got["n_nodes"] == 127
    assert got["fails"] == [] and got["skipped"] == []
    assert got["aborts"] == []
    assert got["reduced"]["to"] == ("127 nodes; 256 reads, 64 pairs; "
                                    "processes of one host, 2 at most")
    assert set(got["build"]["file_bytes"]) == {".msa.npz", ".csfm.npz",
                                               ".hmm", ".ptu.npz"}


@pytest.mark.parametrize("mode,reads", [("se", 256), ("pe", 64)])
def test_harness_runs(harness, mode, reads):
    """Per-process and per-N fields of each run; two processes' gathered
    rows byte-equal to one process's; parity in process 0 of N = 1."""
    got, _ = harness
    runs = got[mode]
    assert set(runs) == {"1", "2"}
    for n, r in runs.items():
        n = int(n)
        assert PER_N <= set(r) and r["fails"] == []
        assert r["processes"] == n and r["reads"] == reads
        assert len(r["procs"]) == n
        assert r["reads_per_s_stream"] == reads / r["stream_gather_s"]
        assert r["stream_gather_s"] >= r["stream_s"]
        for p in r["procs"]:
            assert PER_PROCESS <= set(p)
            assert p["rc"] == p["exit"] == 0 and not p["aborted"]
            assert {"load_s", "upload_s", "stream_s"} <= set(p["clocks"])
            assert ("gather_s" in p["clocks"]) == (n > 1)
            assert 0 < p["stream_cpu_s"] <= p["cpu_s"]
            assert p["torch_threads"] == 1 and p["npz_threads"] > 0
            stages = p["stream_stages_s"]
            inner = {"gen_s", "place_dispatch_s", "place_collect_s"} \
                if mode == "se" else {"align_s", "place_s"}
            assert inner | {"seed_s", "strings_s", "rows_s"} <= set(stages)
            # -C's host clocks only in -C children (CHIMERA_STAGES)
            assert not {"get_seed_s", "chimera_s", "host_sep_s"} & set(stages)
            assert p["viterbi_timing_s"]["host_build"] > 0
        names = ([f"{mode}_n1.aln.fa"] if n == 1 else
                 [f"{mode}_n2.aln.fa.p0", f"{mode}_n2.aln.fa.p1"])
        assert r["align_out"] == dict.fromkeys(names, True)
    one, two = runs["1"], runs["2"]
    assert two["rows_equal"] and two["rows_differ"] == 0
    assert two["rows"] == two["rows_ref"] == one["rows"]
    assert one["rows"] == reads if mode == "se" else one["rows"] <= reads
    p0 = one["procs"][0]
    assert p0["parity_reads"] >= 0.9 * 32
    assert p0["parity_cnode_match"] >= 0.95 * p0["parity_reads"]
    assert p0["parity_loglik_match"] >= 0.95 * p0["parity_reads"]
    assert all("parity_reads" not in p for p in two["procs"])
    # process 0's shard starts at read 0, process 1's after it
    assert sum(p["processed"][-1][1] for p in two["procs"]) == reads


def test_two_processes_match_reference_cli(harness, tmp_path):
    """The N = 2 gathered TSV against the reference package's assign CLI
    run as one process on the same DB files (read by np.load)."""
    from hmmufotu_tpu.cli.assign import main as ref_assign
    _, work = harness
    want = str(tmp_path / "ref.tsv")
    assert ref_assign([str(work / "db"), str(work / "reads.fasta"), "-o",
                       want]) == 0
    got = tsv_rows(work / "se_n2.tsv")
    assert len(got) == 256
    assert_tsv_agree(got, tsv_rows(want))


def proc(stream_s, returned_at, gather_s=None):
    clocks = {"stream_s": stream_s}
    if gather_s is not None:
        clocks["gather_s"] = gather_s
    return {"clocks": clocks, "main_returned_at": returned_at}


def test_rates_and_efficiency(scripts_path):
    from torch_scale_procs import rates
    one = rates(1, 1000, [proc(10.0, 120.0)], 100.0, None)
    assert one["reads_per_s_stream"] == 100.0
    assert one["reads_per_s_wall"] == 50.0
    assert one["efficiency_stream"] == one["efficiency_wall"] == 1.0
    # the slowest stream + gather sets the stream rate (process 0 writes
    # the TSV in its gather at N > 1, the stream itself at N = 1), the
    # last return the wall
    three = rates(3, 1000, [proc(4.0, 110.0, 1.0), proc(4.5, 125.0, 0.1),
                            proc(2.0, 105.0, 0.5)], 100.0, one)
    assert three["stream_s"] == 4.5 and three["wall_s"] == 25.0
    assert three["stream_gather_s"] == 5.0
    assert three["reads_per_s_stream"] == 200.0
    assert three["efficiency_stream"] == pytest.approx(200.0 / 300.0)
    assert three["efficiency_wall"] == pytest.approx(40.0 / 150.0)


def test_skip_arithmetic(scripts_path):
    from torch_scale_procs import skip_reason
    # 65,535 nodes on one card: three fit, four do not (4 x 22 > 76)
    assert skip_reason(3, 20.0, 21.0, 101, True) is None
    got = skip_reason(4, 20.0, 21.0, 101, True)
    assert set(got) == {"processes", "card"}
    assert got["card"]["need_gb"] == 88.0
    # 149,999 nodes: 3 x 37.25 + 5 > 101 GB; each process its own card
    got = skip_reason(3, 37.25, 42.07, 101, False)
    assert set(got) == {"processes", "host"}
    assert got["host"]["need_gb"] == pytest.approx(116.75)
    assert skip_reason(4, 37.25, 42.07, 377, False) is None
    assert skip_reason(2, 37.25, None, None, True) is None


def test_abort_scan(scripts_path):
    from torch_scale_procs import abort_scan
    clean = abort_scan("INFO: Processed 256 reads\n", 0, 0)
    assert clean == {"abort_lines": [], "aborted": False,
                     "abort_after_rows": False}
    # the gloo exit abort: rows written (the CLI returned 0), then
    # SIGABRT at interpreter exit
    err = ("INFO: Assigned 128 of 128 reads\n"
           "terminate called without an active exception\n")
    got = abort_scan(err, 0, -6)
    assert got["aborted"] and got["abort_after_rows"]
    assert got["abort_lines"] == ["terminate called without an active "
                                  "exception"]
    # a failure before the rows: no JSON line (rc None), non-zero exit
    got = abort_scan("Traceback ...\nRuntimeError: x\n", None, 1)
    assert not got["aborted"] and not got["abort_after_rows"]
    got = abort_scan("Fatal Python error: Segmentation fault\n", None, -11)
    assert got["aborted"] and not got["abort_after_rows"]


def test_child_env(scripts_path):
    """--card-per-process: child i sees card i alone, a -C child card 0;
    without it they share the card.  (A mesh run's one process sees
    every card: test_mesh_harness_runs.)"""
    from torch_scale_procs import child_env
    assert child_env(2, True) == {"CUDA_VISIBLE_DEVICES": "2"}
    assert child_env(0, True) == {"CUDA_VISIBLE_DEVICES": "0"}
    assert child_env(1, False) is None
    assert child_env(5, True, chimera=True) == {
        "CUDA_VISIBLE_DEVICES": "0"}
    assert child_env(5, False, chimera=True) is None


def test_rows_compare(scripts_path, tmp_path):
    from torch_scale_procs import rows_compare
    head = "# command: x\nid\tdescription\n"
    a, b, c = (tmp_path / f"{k}.tsv" for k in "abc")
    a.write_text(head + "r0\t1\nr1\t2\n")
    b.write_text("# command: y\nid\tdescription\nr0\t1\nr1\t2\n")
    c.write_text(head + "r0\t1\nr1\t3\nr2\t4\n")
    assert rows_compare([str(a)], str(b)) == {
        "rows": 2, "rows_ref": 2, "rows_differ": 0, "rows_equal": True}
    got = rows_compare([str(c)], str(a))
    assert got == {"rows": 3, "rows_ref": 2, "rows_differ": 2,
                   "rows_equal": False}


def test_failed_child_stops_the_run(scripts_path):
    """A child that exits non-zero leaves the others `grace` seconds,
    then they are killed: no run waits out gloo's timeout, and each
    child's failure shows (rc None: no JSON line)."""
    import time
    from torch_scale_procs import finish_all
    t = time.perf_counter()
    children = [(subprocess.Popen([sys.executable, "-c", code],
                                  stdout=subprocess.PIPE, text=True), t)
                for code in ("import sys; sys.exit(3)",
                             "import time; time.sleep(120)")]
    got = finish_all(children, grace=1.0)
    assert time.perf_counter() - t < 60
    assert [g["exit"] for g in got] == [3, -9]
    assert [g["rc"] for g in got] == [None, None]


# ---------------------------------------------------------------------------
# assign -C runs
# ---------------------------------------------------------------------------

CHIMERA_SHAPE = ["--leaves", "64", "--length", "600", "--reads", "0",
                 "--pair-processes", "", "--chimera-reads", "40",
                 "--chimera-processes", "1,2",
                 "--eval-engine", "numpy", "--device", "cpu"]
CHIMERA_STAGES = {"align_s", "get_seed_s", "chimera_s",
                  "chimera_segments_s", "host_sep_s", "rows_s"}


@pytest.fixture(scope="module")
def chimera_harness(tmp_path_factory):
    """One CPU run of the harness's -C runs alone at the tiny shape: its
    JSON line and work directory."""
    work = tmp_path_factory.mktemp("chim")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "torch_scale_procs.py")]
        + CHIMERA_SHAPE + ["--work", str(work)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), work


def test_chimera_harness_runs(chimera_harness):
    """-C at N = 1 and 2 alone (--reads 0): no placer built, the gathered
    rows and the .p<i> chimera files against one process's, each
    process's stage clocks and seconds a read by stage, and the CPU
    run's rows against the N = 1 run's."""
    got, work = chimera_harness
    assert got["fails"] == [] and got["aborts"] == []
    assert got["se"] == {} and got["pe"] == {}
    assert got["reduced"]["to"] == ("127 nodes; 40 -C reads (of 1024 "
                                    "asked); processes of one host, 2 at "
                                    "most")
    one, two = got["chim"]["1"], got["chim"]["2"]
    assert one["reads"] == two["reads"] == 40
    assert one["rows"] + one["chimera_rows"] == 40
    assert one["chimera_rows"] > 0
    assert two["rows_equal"] and two["rows"] == one["rows"]
    assert two["chimera_out"]["files"] == ["chim_n2.chi.tsv.p0",
                                           "chim_n2.chi.tsv.p1"]
    assert two["chimera_out"]["rows_differ"] == 0
    assert two["chimera_out"]["rows"] == one["chimera_rows"]
    for r in (one, two):
        for p in r["procs"]:
            assert "upload_s" not in p["clocks"]
            assert "parity_reads" not in p
            assert CHIMERA_STAGES <= set(p["stream_stages_s"])
            split = p["chimera_split_s_per_read"]
            assert sum(split.values()) * p["processed"][-1][1] \
                == pytest.approx(p["clocks"]["stream_s"], rel=1e-6)
            assert min(split.values()) >= 0
    cpu = got["chimera_cpu"]
    assert cpu["ok"] and cpu["reads"] == 32 and cpu["rows_equal"] == 32
    assert "upload_s" not in cpu["clocks"]
    det = got["chimera_detection"]
    assert det["planted"]["reads"] == 4 and det["clean"]["reads"] == 36
    assert sum(det[b]["reads"] for b in ("pdist<3%", "pdist3-10%",
                                         "pdist>=10%")) == 4


def test_chimera_rows_match_reference_cli(scripts_path, chimera_harness,
                                          tmp_path):
    """The N = 2 gathered -C rows and chimera files against the
    reference package's assign CLI as one process on the same DB files
    and flags: host f64 placement in both, the same bytes."""
    from hmmufotu_tpu.cli.assign import main as ref_assign
    from torch_scale_procs import rows_compare
    _, work = chimera_harness
    out, chi = str(tmp_path / "ref.tsv"), str(tmp_path / "ref.chi.tsv")
    assert ref_assign([str(work / "db"), str(work / "chim.fasta"), "-o",
                       out, "-C", "-s", "1", "-b", "64", "--chimera-out",
                       chi]) == 0
    assert rows_compare([str(work / "chim_n2.tsv")], out)["rows_equal"]
    assert rows_compare([str(work / "chim_n2.chi.tsv.p0"),
                         str(work / "chim_n2.chi.tsv.p1")],
                        chi)["rows_equal"]


def chimera_tree(tmp_path):
    from evolved_inputs import input_tree, synth_inputs
    synth_inputs(str(tmp_path), 64, 600)
    return input_tree(str(tmp_path))


def test_chimera_read_maker(scripts_path, tmp_path):
    """Deterministic from its seed; every tenth read a chimera of two
    distinct leaves whose 5' part (30-70% of the read) ends at the break
    column of leaf a and whose 3' part starts at b's next residue
    column; the recorded p-distance is the parents' over the read's
    columns."""
    import numpy as np
    from torch_scale_procs import p_dists, simulate_chimera_reads
    tree = chimera_tree(tmp_path)
    L = tree.cs_len
    reads = simulate_chimera_reads(tree, np.random.default_rng(3), 60,
                                   (0, L))
    again = simulate_chimera_reads(tree, np.random.default_rng(3), 60,
                                   (0, L))
    assert reads == again
    assert [rid for rid, _, _ in reads] == [f"r{i}" for i in range(60)]
    planted = [i for i, (_, desc, _) in enumerate(reads)
               if desc.startswith("chimera=1 ")]
    assert planted == list(range(9, 60, 10))
    node = {name: u for u, name in enumerate(tree.names)}
    for i, (_, desc, seq) in enumerate(reads):
        assert len(seq) == 250
        truth = dict(kv.split("=", 1) for kv in desc.split())
        if i not in planted:
            assert truth == {"chimera": "0", "parents": truth["parents"]}
            continue
        a, b = (node[x] for x in truth["parents"].split(","))
        brk = int(truth["break"])
        assert a != b
        pos_a = np.nonzero(tree.seqs[a] >= 0)[0]
        pos_b = np.nonzero(tree.seqs[b] >= 0)[0]
        pos_a, pos_b = pos_a[pos_a <= brk], pos_b[pos_b > brk]
        assert pos_a[-1] == brk
        codes = np.asarray(["ACGT".index(c) for c in seq])
        # the 5' length k whose parts fit the read best: 2% substitutions
        fit = {k: int((np.concatenate([tree.seqs[a][pos_a[-k:]],
                                       tree.seqs[b][pos_b[:250 - k]]])
                       != codes).sum())
               for k in range(1, 250) if k <= len(pos_a)
               and 250 - k <= len(pos_b)}
        k = min(fit, key=fit.get)
        assert fit[k] <= 20 and 75 <= k <= 175
        pd = p_dists(tree.seqs, np.asarray([b]), a, pos_a[-k],
                     pos_b[250 - k - 1])[0]
        assert float(truth["pdist"]) == pytest.approx(pd, abs=1e-6)


def test_chimera_detection_counts(scripts_path, tmp_path):
    """Planted reads flagged by bin, clean reads flagged, lod quantiles,
    on hand-made TSVs (the lod in column 15)."""
    from torch_scale_procs import detection

    def row(rid, desc, lod):
        return "\t".join([rid, desc] + ["0"] * 12 + [lod, "x"]) + "\n"

    head = "# x\nid\tdescription\n"
    main, chi = tmp_path / "a.tsv", tmp_path / "a.chi.tsv"
    main.write_text(head + row("r0", "chimera=0 parents=S1", "0")
                    + row("r1", "chimera=1 parents=S1,S2 break=9 "
                          "pdist=0.050000", "-2.5")
                    + row("r2", "chimera=0 parents=S3", "nan"))
    chi.write_text(head + row("r3", "chimera=1 parents=S4,S5 break=7 "
                              "pdist=0.010000", "12")
                   + row("r4", "chimera=1 parents=S4,S6 break=8 "
                         "pdist=0.300000", "40")
                   + row("r5", "chimera=1 parents=S4,S7 break=8 "
                         "pdist=0.100000", "20")
                   + row("r6", "chimera=0 parents=S8", "3"))
    got = detection(str(main), str(chi))
    assert got["pdist<3%"] == {"reads": 1, "flagged": 1, "share": 1.0,
                               "lod_quantiles": [12.0] * 5,
                               "lod_not_finite": 0}
    assert got["pdist3-10%"]["flagged"] == 0
    assert got["pdist3-10%"]["lod_quantiles"] == [-2.5] * 5
    assert got["pdist>=10%"]["reads"] == 2
    assert got["pdist>=10%"]["lod_quantiles"] == [20.0, 25.0, 30.0, 35.0,
                                                  40.0]
    assert got["planted"]["reads"] == 4 and got["planted"]["flagged"] == 3
    assert got["clean"] == {"reads": 3, "flagged": 1, "share": 1 / 3,
                            "lod_quantiles": [0.0, 0.75, 1.5, 2.25, 3.0],
                            "lod_not_finite": 1}


@pytest.mark.parametrize("launches, chimera, ok", [
    ({"viterbi_traced": 4, "est": 0, "sep_optimize": 0}, True, True),
    ({"viterbi_traced": 4, "est": 2, "sep_optimize": 0}, True, False),
    ({"viterbi_traced": 4, "est": 0, "sep_optimize": 1}, True, False),
    ({"viterbi_traced": 0, "est": 0, "sep_optimize": 0}, True, False),
    ({"viterbi_traced": 4, "est": 2, "sep_optimize": 2}, False, True),
    ({"viterbi_traced": 4, "est": 0, "sep_optimize": 0}, False, False)],
    ids=["C-K1-only", "C-K2", "C-K3", "C-no-K1", "stream", "stream-no-K2"])
def test_launch_gate(scripts_path, launches, chimera, ok):
    """-C: K1 at least once, K2 and K3 never; otherwise every kernel."""
    from torch_scale_procs import launch_fails
    got = launch_fails("t", {"process_id": 0, "launches": launches},
                       chimera)
    assert (got is None) == ok


def test_cpu_rows_compare(scripts_path):
    """One read whose alignment differs passes and is named; a second,
    or a row that differs with the same alignment, or a read missing on
    the card, fails."""
    from torch_scale_procs import cpu_rows_compare

    def row(rid, aln="AC", lod="1"):
        return "\t".join([rid, "d"] + ["1"] * 7 + [aln, lod]) + "\n"

    card = {f"r{i}": (i == 2, row(f"r{i}")) for i in range(4)}
    same = dict(card)
    got = cpu_rows_compare(same, card, 4)
    assert got["ok"] and got["rows_equal"] == 4
    tie = dict(card, r1=(False, row("r1", aln="A-C")))
    got = cpu_rows_compare(tie, card, 4)
    assert got["ok"] and got["alignment_differs"] == ["r1"]
    two = dict(tie, r3=(False, row("r3", aln="A-C")))
    assert not cpu_rows_compare(two, card, 4)["ok"]
    lod = dict(card, r0=(False, row("r0", lod="2")))
    got = cpu_rows_compare(lod, card, 4)
    assert not got["ok"] and got["rows_differ"] == ["r0"]
    flag = dict(card, r2=(False, row("r2")))
    assert not cpu_rows_compare(flag, card, 4)["ok"]
    assert not cpu_rows_compare(dict(card, r9=(False, row("r9"))),
                                card, 5)["ok"]
    assert not cpu_rows_compare(same, card, 5)["ok"]


# ---------------------------------------------------------------------------
# assign --mesh and --mesh-tree runs
# ---------------------------------------------------------------------------

MESH_TREE_SHAPE = ["--leaves", "64", "--length", "600", "--reads", "32",
                   "--pairs", "8", "--processes", "1", "--pair-processes",
                   "1", "--mesh", "--mesh-tree", "--parity", "16",
                   "--device", "cpu", "--eval-engine", "numpy"]


@pytest.fixture(scope="module")
def mesh_tree_harness(tmp_path_factory):
    """One CPU run of the harness with --mesh and --mesh-tree at the tiny
    shape (four CPU shards): its JSON line and work directory."""
    work = tmp_path_factory.mktemp("mesh_tree")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "torch_scale_procs.py")]
        + MESH_TREE_SHAPE + ["--work", str(work)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), work


@pytest.mark.parametrize("mode,reads", [("se", 32), ("pe", 8)])
def test_mesh_tree_harness_runs(mesh_tree_harness, mode, reads):
    """The --mesh-tree run after the N = 1 run of each input: one process
    over four CPU shards (node blocks of 32 of the 127 nodes, each one's
    message bytes), its clocks, its rows against the N = 1 run's branches,
    and for single-end reads the CPU shards' run of the first 32 reads
    agreeing row for row."""
    got, work = mesh_tree_harness
    assert got["fails"] == [] and got["aborts"] == []
    # five runs and the --mesh-tree CPU reference
    assert got["processes_scanned"] == 6
    assert got["reduced"]["to"] == (
        "127 nodes; 32 reads, 8 pairs, the first 32 reads and 8 pairs "
        "under --mesh-tree; processes of one host, 1 at most")
    r = got[f"mesh_tree_{mode}"]
    assert r["fails"] == [] and r["processes"] == 1 and r["reads"] == reads
    assert r["rows"] == reads
    assert r["reads_per_s_stream"] == reads / r["stream_gather_s"]
    assert r["align_out"] == {f"{mode}_mesh_tree.aln.fa": True}
    p = r["procs"][0]
    assert p["rc"] == p["exit"] == 0 and not p["aborted"]
    assert p["cards_seen"] == 0 and "device_peaks_gb" not in p
    assert p["cuda_visible_devices"] is None
    pl = r["placement"]
    assert [s["node_lo"] for s in pl["shards"]] == [0, 32, 64, 96]
    assert {s["device"] for s in pl["shards"]} == {"cpu"}
    # [32, 4, 600] f32 up and down messages a shard, the last one padded
    assert r["shard_msg_bytes"] == [2 * 32 * 4 * 600 * 4] * 4
    assert pl["tree_shards_s"] > 0 and pl["merge_s"] > 0
    assert 0 < pl["merge_s"] < pl["place_s"] < r["stream_s"]
    assert pl["card_busy_ms"] == {} and pl["busy_over_place"] is None
    one = r["one_card"]
    assert one["rows"] == one["matched"] == reads
    assert one["same_branch"] + one["other_branch"] == one["placed"]
    assert one["share"] == one["same_branch"] / one["placed"]
    if mode == "se":
        cpu = r["cpu"]
        assert cpu["ok"] and cpu["reads"] == cpu["agree"] == 32
        assert cpu["differ"] == cpu["differ_rows"] == []
        assert cpu["near_ties"] == cpu["fails"] == []
        assert cpu["near_tie_limit"] == 8 and cpu["f64_load_s"] is None
        assert not cpu["aborted"] and cpu["process_id"] == 0
        assert "tree_shards_s" in cpu["clocks"]
        assert (work / "mt_cpu.tsv").exists()
    else:
        assert "cpu" not in r
    assert got[mode]["1"]["fails"] == []


def test_mesh_harness_runs(mesh_tree_harness):
    """The --mesh run after the single-end N = 1 run: one process over
    four CPU shards (a replica a shard, no tree shards), its rows
    byte-equal to the N = 1 run's, its placement clocks."""
    got, _ = mesh_tree_harness
    r = got["mesh"]
    assert r["run"] == "se_mesh" and r["fails"] == []
    assert r["processes"] == 1 and r["reads"] == 32
    assert r["rows"] == r["rows_ref"] == 32 and r["rows_equal"]
    assert r["rows_differ"] == 0
    assert r["align_out"] == {"se_mesh.aln.fa": True}
    p = r["procs"][0]
    assert p["rc"] == p["exit"] == 0 and p["cuda_visible_devices"] is None
    pl = r["placement"]
    assert pl["shards"] is None and pl["tree_shards_s"] is None
    assert 0 < pl["place_s"] < r["stream_s"]
    assert "shard_msg_bytes" not in r and "one_card" not in r


def test_mesh_tree_rows_match_reference_cli(mesh_tree_harness, tmp_path):
    """The --mesh-tree run's rows against the reference package's assign
    CLI with --mesh-tree on a four-device CPU mesh, on the same DB files
    and reads: the same ids, alignments, branch and taxon, logliks within
    the pipeline tolerances."""
    from conftest import run_on_cpu_mesh
    from test_torch_parallel import rows_agree
    _, work = mesh_tree_harness
    out = str(tmp_path / "ref.tsv")
    code = ("from hmmufotu_tpu.cli.assign import main\n"
            "import jax\n"
            "assert len(jax.devices()) == 4\n"
            f"assert main([{str(work / 'db')!r}, "
            f"{str(work / 'mt_reads.fasta')!r}, '-o', {out!r}, "
            "'--mesh-tree']) == 0\n")
    res = run_on_cpu_mesh(code, n_devices=4, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    port = tsv_rows(work / "se_mesh_tree.tsv")
    assert len(port) == 32
    rows_agree(port, tsv_rows(out))


@pytest.mark.parametrize("doctor", ["loglik", "far branch"])
def test_mesh_tree_doctored_cpu_row_fails(scripts_path, mesh_tree_harness,
                                         tmp_path, monkeypatch, capsys,
                                         doctor):
    """One CPU row off by 5 nats in loglik, or moved to the branch of the
    node farthest from its read (its f64 score many ulps below the f64
    best): the harness exits 1 and names the read, the second with both
    branches' f64 scores.  The --mesh-tree run alone (--processes ''), on
    the fixture's DB files (build_db reuses them)."""
    import shutil
    import torch_scale_procs as tsp
    from hmmufotu_tpu_torch.phylo.tree import PTUnrooted, p_dist
    _, work = mesh_tree_harness
    for f in os.listdir(work):
        if f.startswith("db") or f == "db_shape.json":
            shutil.copy(work / f, tmp_path / f)
    tree = PTUnrooted.load(str(tmp_path / "db.ptu.npz"))
    build = tsp.build_db
    monkeypatch.setattr(tsp, "build_db",
                        lambda args, d: build(args, d, reuse=True))
    split = tsp.split_rows
    far = []

    def doctored(path):
        rows = split(path)
        if path.endswith("mt_cpu.tsv"):
            r = rows[3]
            if doctor == "loglik":
                r[15] = str(float(r[15]) + 5.0)
            else:
                seq, start, end = tsp.aligned_read(r)
                c = max((u for u in range(tree.num_nodes)
                         if tree.parent[u] >= 0),
                        key=lambda u: p_dist(tree.seqs[u], seq, start, end))
                r[10] = f"{c}->{tree.parent[c]}"
                far.append(r[10])
        return rows

    monkeypatch.setattr(tsp, "split_rows", doctored)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc = tsp.main(["--leaves", "64", "--length", "600", "--reads", "8",
                   "--pairs", "0", "--processes", "", "--parity", "0",
                   "--mesh-tree", "--device", "cpu", "--eval-engine",
                   "numpy", "--work", str(tmp_path)])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1
    assert got["build"]["reused"]
    assert got["fails"] == [got["mesh_tree_se"]["fails"][0]]
    cpu = got["mesh_tree_se"]["cpu"]
    card = tsp.split_rows(str(tmp_path / "se_mesh_tree.tsv"))[3]
    assert [r["id"] for r in cpu["differ_rows"]] == ["r3"]
    assert cpu["differ_rows"][0]["card"] == card[10:]
    assert got["mesh_tree_se"]["cpu"]["reads"] == 8
    assert got["se"] == {} and "one_card" not in got["mesh_tree_se"]
    assert got["processes_scanned"] == 2 and got["aborts"] == []
    if doctor == "loglik":
        assert cpu["differ"] == cpu["fails"] == ["r3: loglik"]
        assert float(cpu["differ_rows"][0]["cpu"][5]) == \
            pytest.approx(float(card[15]) + 5.0, rel=1e-6)
        assert "f64" not in cpu["differ_rows"][0]
        assert cpu["f64_load_s"] is None
        return
    assert cpu["differ"] == ["r3: branch or taxon"] and far != [card[10]]
    f = cpu["differ_rows"][0]["f64"]
    assert (f["card_branch"], f["cpu_branch"]) == (card[10], far[0])
    assert f["verdict"] == "not a near tie" and f["cpu_gap_ulps"] > 1000
    assert f["cpu_loglik"] < f["best_loglik"] and cpu["near_ties"] == []
    assert cpu["fails"] == [
        f"r3: branch or taxon, not a near tie: f64 card {card[10]} "
        f"{f['card_loglik']!r}, CPU {far[0]} {f['cpu_loglik']!r}, best "
        f"{f['best_branch']} {f['best_loglik']!r} "
        f"({f['card_gap_ulps']:.3f}, {f['cpu_gap_ulps']:.3f} ulps)"]
    assert "r3: branch or taxon, not a near tie" in got["fails"][0]
    assert cpu["f64_load_s"] > 0 and cpu["f64_score_s"] > 0


def synth_row(rid, aln="AC", branch="7->9", taxon="3", ll="-100.0"):
    """A row of an assignment TSV, split into fields."""
    return [rid, "d"] + ["1"] * 7 + [aln, branch, "0.5", taxon, "t",
                                     "0.1", ll, "20", "20"]


TIE_BEST = -1.0e6


FOUR = [f"r{k}" for k in range(0, 32, 4)]      # 8 of 32 rows: 25%


@pytest.mark.parametrize("flips, aln, ties, fails", [
    pytest.param({}, [], [], [], id="equal"),
    pytest.param({"r5": (0.0, 7.5)}, [], ["r5"], [], id="tie"),
    pytest.param({"r5": (-7.5, 3.0)}, [], ["r5"], [], id="card-above"),
    pytest.param({"r5": (0.0, 9.0)}, [], [], ["r5"], id="9-ulps"),
    pytest.param({"r5": (-9.0, 0.0)}, [], [], ["r5"], id="card-9-above"),
    pytest.param(dict.fromkeys(FOUR, (0.0, 3.0)), [], FOUR, [],
                 id="at-limit"),
    pytest.param(dict.fromkeys(FOUR + ["r1"], (0.0, 3.0)), [],
                 ["r0", "r1"] + FOUR[1:],
                 ["9 near ties in 32 rows, over 25% (8)"], id="over-limit"),
    pytest.param({"r5": (0.0, 0.0)}, ["r5"], [],
                 ["r5: alignment, branch or taxon"], id="alignment"),
])
def test_f64_near_tie_rule(scripts_path, flips, aln, ties, fails):
    """f64_near_ties on 32 hand-made rows, the card's branch and taxon
    flipped on `flips` ({id: (card, CPU) gap below the f64 best in f32
    ulps}) and its alignment changed on `aln`: a flip passes only with
    both branches within 8 ulps of the best, either way, on at most 25%
    of the rows; a flip beside another difference fails as that,
    unscored; a flip that fails is named with both f64 scores."""
    from torch_scale_procs import f64_near_ties
    ulp = abs(TIE_BEST) * 2.0 ** -23
    cpu = [synth_row(f"r{k}") for k in range(32)]
    card = [synth_row(f"r{k}", aln="A-C" if f"r{k}" in aln else "AC",
                      branch="8->9" if f"r{k}" in flips else "7->9",
                      taxon="4" if f"r{k}" in flips else "3")
            for k in range(32)]
    asked = []

    def score(g, w):
        asked.append(g[0])
        c, p = flips[g[0]]
        return {"best_branch": "7->9", "best_loglik": TIE_BEST,
                "card_branch": g[10], "cpu_branch": w[10],
                "card_loglik": TIE_BEST - c * ulp,
                "cpu_loglik": TIE_BEST - p * ulp}

    got = f64_near_ties(card, cpu, score)
    assert got["ok"] is (not fails) and got["reads"] == 32
    assert got["agree"] == 32 - len(flips)
    scored = [] if aln else sorted(flips, key=lambda r: int(r[1:]))
    assert asked == scored and got["near_ties"] == ties
    assert [r["id"] for r in got["differ_rows"]] == sorted(
        flips, key=lambda r: int(r[1:]))
    for r in got["differ_rows"]:
        assert ("f64" in r) is (r["id"] in scored)
        assert r["card"][0] == "8->9" and r["cpu"][0] == "7->9"
    if fails != ["r5"]:
        assert got["fails"] == fails
        for r in got["differ_rows"]:
            assert r["id"] in aln or r["f64"]["verdict"] == "near tie"
        return
    f = got["differ_rows"][0]["f64"]
    c, p = flips["r5"]
    assert f["verdict"] == "not a near tie" and f["ulp"] == ulp
    assert (f["card_gap_ulps"], f["cpu_gap_ulps"]) == \
        (pytest.approx(c), pytest.approx(p))
    assert got["fails"] == [
        f"r5: branch or taxon, not a near tie: f64 card 8->9 "
        f"{f['card_loglik']!r}, CPU 7->9 {f['cpu_loglik']!r}, best "
        f"7->9 {TIE_BEST!r} ({c:.3f}, {p:.3f} ulps)"]


def test_f64_score_of_host_best(scripts_path, mesh_tree_harness):
    """On the fixture's DB files and the CPU shards' rows of its first 32
    reads: F64Scores' best and its score of assign_read's own branch are
    assign_read's loglik, exactly; a row scored against itself gives
    both sides one score."""
    from types import SimpleNamespace
    from hmmufotu_tpu_torch import pipeline as pl
    from torch_scale_procs import (F64Scores, aligned_read, near_tie,
                                   split_rows)
    _, work = mesh_tree_harness
    score = F64Scores(str(work / "db"))
    rows = split_rows(str(work / "mt_cpu.tsv"))
    assert len(rows) == 32
    got = score(rows[0], rows[0])
    assert score.load_s > 0 and score.score_s > 0
    assert got["card_loglik"] == got["cpu_loglik"] <= got["best_loglik"]
    assert got["card_branch"] == got["cpu_branch"] == rows[0][10]
    gaps = near_tie(got["best_loglik"], got["card_loglik"],
                    got["cpu_loglik"])
    assert gaps["card_gap_ulps"] == gaps["cpu_gap_ulps"] >= 0
    for r in rows:
        seq, start, end = aligned_read(r)
        best = pl.assign_read(
            score.tree, SimpleNamespace(cs_start=start + 1, cs_end=end + 1),
            seq)
        assert score.branch(seq, start, end, best.get_id()) == best.loglik
        assert score.best(seq, start, end).loglik == best.loglik


def test_rows_differ(scripts_path):
    """The rows rule of tests/test_torch_parallel.py, naming each row
    that breaks it and what differs."""
    from torch_scale_procs import rows_differ

    def row(rid, aln="AC", branch="7", taxon="3", ll="-100.0"):
        return [rid, "d"] + ["1"] * 7 + [aln, branch, "0.5", taxon, "t",
                                         "0.1", ll, "20", "20"]

    # an unplaced read's row: branch NULL, loglik nan (place_tsv)
    want = [row("r0"), row("r1"), row("r2", branch="NULL", ll="nan")]
    assert rows_differ([list(r) for r in want], want) == []
    # within 1e-4 relative or 0.5
    assert rows_differ([row("r0", ll="-100.4"), row("r1"), want[2]],
                       want) == []
    got = [row("r0", aln="A-C"), row("r1", branch="8", ll="-101"),
           row("r2")]
    assert rows_differ(got, want) == ["r0: alignment",
                                      "r1: branch or taxon, loglik",
                                      "r2: placement"]
    assert rows_differ(want[:2], want) == ["row 2: ids [None, 'r2']"]
    assert rows_differ([row("r9")] + want[1:], want) == [
        "row 0: ids ['r9', 'r0']"]


def test_one_card_share(scripts_path, tmp_path):
    """Rows of the --mesh-tree run against the one-card run's by id: the
    share on the same branch and the loglik deficit of the others."""
    from torch_scale_procs import one_card_share

    def row(rid, branch, ll):
        return "\t".join([rid, "d"] + ["1"] * 8
                         + [branch, "0.5", "3", "t", "0.1", ll, "20",
                            "20"]) + "\n"

    head = "# x\nid\tdescription\n"
    one, mt = tmp_path / "one.tsv", tmp_path / "mt.tsv"
    one.write_text(head + row("r0", "5", "-10") + row("r1", "6", "-20")
                   + row("r2", "7", "-30") + row("r3", "NULL", "nan")
                   + row("r4", "9", "-50"))
    mt.write_text(head + row("r0", "5", "-10") + row("r1", "4", "-23")
                  + row("r2", "8", "-29") + row("r3", "NULL", "nan"))
    got = one_card_share(str(mt), str(one))
    assert got == {"rows": 4, "matched": 4, "placed": 3, "same_branch": 1,
                   "share": 1 / 3, "other_branch": 2, "unplaced_differ": 0,
                   "loglik_deficit_quantiles": [-1.0, 0.0, 1.0, 2.0, 3.0],
                   "deficit_below_zero": 1}
