"""The port's tracer (utils.trace, HMMUFOTU_TIMING=1) on the 70_otus
fixture: off it records nothing, on it records each batch's spans on
both threads of assign_stream and the counters; the assign rows are
byte-identical either way; its clock maps onto a profiler trace's."""

import json
import logging
import os
import sys
import threading

import numpy as np
import pytest
import torch

from test_torch_pipeline import (db_prefix, one_torch_thread,  # noqa: F401
                                 simulate_reads)

from hmmufotu_tpu_torch.utils import trace

BATCH = 16
MAIN_SPANS = {"batch", "wait_seed", "dp", "scalars_dl", "trace_dl",
              "host_build", "place_dispatch"}
WORKER_SPANS = {"dispatch", "seed", "encode", "dp_dispatch"}
PLACE_SPANS = {"place_collect", "place_wait"}


@pytest.fixture
def tracer():
    """The tracer emptied, its switch put back after the test."""
    was = trace.ON
    trace.reset()
    yield trace
    trace.enable(was)
    trace.reset()


@pytest.fixture(scope="module")
def stream_parts(db_prefix):  # noqa: F811
    from hmmufotu_tpu_torch.db import Database
    from hmmufotu_tpu_torch.hmm import NGCL, ViterbiAligner
    from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
    db = Database.load(db_prefix)
    db.hmm.set_sequence_mode(NGCL)
    db.hmm.wing_retract()
    return (db, ViterbiAligner(db.hmm, device="cpu"),
            DevicePlacer(db.ptu, device="cpu"))


def run_stream(parts, reads):
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch.hmm import NGCL
    db, aligner, placer = parts
    return list(pl.assign_stream(aligner, db.csfm, db.ptu, placer, reads,
                                 BATCH, mode=NGCL))


def profiled(fn):
    """fn() under a CPU torch profiler: (its result, the chrome trace's
    user_annotation events)."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        events = json.load(open(path))["traceEvents"]
    return out, [e for e in events if e.get("cat") == "user_annotation"]


def test_off_records_nothing_and_opens_no_record_function(
        stream_parts, tracer, monkeypatch):
    reads = simulate_reads(stream_parts[0].ptu, 2 * BATCH, seed=11)
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or real(name))
    tracer.enable(False)
    got, anns = profiled(lambda: run_stream(stream_parts, reads))
    assert len(got) == 2
    assert tracer.records() == [] and tracer.counts() == {}
    assert opened == []
    names = MAIN_SPANS | WORKER_SPANS | PLACE_SPANS
    assert not [e for e in anns if e["name"] in names]
    assert tracer.span("x") is tracer.span("y")     # one shared object


def test_on_records_each_batch_on_both_threads(stream_parts, tracer):
    reads = simulate_reads(stream_parts[0].ptu, 3 * BATCH, seed=12)
    tracer.enable(True)
    assert len(run_stream(stream_parts, reads)) == 3
    recs = tracer.records()
    by_id = {r.id: r for r in recs}
    main = threading.get_ident()
    threads = {r.thread for r in recs}
    assert main in threads and len(threads) == 2
    for k in range(3):
        mine = [r for r in recs if r.batch == k]
        names = {r.name for r in mine}
        assert MAIN_SPANS | WORKER_SPANS | PLACE_SPANS <= names
        batch = [r for r in mine if r.name == "batch"]
        dispatch = [r for r in mine if r.name == "dispatch"]
        assert len(batch) == len(dispatch) == 1
        assert batch[0].thread == main and batch[0].parent is None
        assert dispatch[0].thread != main and dispatch[0].parent is None
        for r in mine:
            assert r.end_ns >= r.start_ns and r.cpu_ns >= 0
            if r.name in MAIN_SPANS - {"batch"}:
                assert r.thread == main
                assert by_id[r.parent].name == "batch"
            elif r.name in WORKER_SPANS - {"dispatch"}:
                assert r.thread == dispatch[0].thread
                assert r.parent == dispatch[0].id
        collect = [r for r in mine if r.name == "place_collect"]
        wait = [r for r in mine if r.name == "place_wait"]
        assert len(collect) == len(wait) == 1
        assert wait[0].parent == collect[0].id
        # batch k's placement is collected in batch k+1's span, the last
        # one after the loop
        up = by_id.get(collect[0].parent)
        assert (up.batch == k + 1) if k < 2 else up is None
    cnt = tracer.counts()
    assert cnt["seed_reads"] == cnt["aln_reads"] == 3 * BATCH
    assert cnt["seed_miss"] == 0 and cnt["band_fail"] == 0
    assert "seed_miss" in tracer.summary()


def test_a_seedless_read_counts_one_seed_miss(stream_parts, tracer):
    # every read of seed 12 has a seed hit (the stream test counts none)
    reads = simulate_reads(stream_parts[0].ptu, BATCH - 1, seed=12)
    rng = np.random.default_rng(13)
    reads.insert(5, "".join(rng.choice(list("ACGT"), 250)))
    tracer.enable(True)
    (alns, _), = run_stream(stream_parts, reads)
    assert tracer.counts()["seed_reads"] == BATCH
    assert tracer.counts()["seed_miss"] == 1


def test_a_failed_band_counts_one_band_fail(stream_parts, tracer):
    """A seed band past the profile's end leaves no cell to align: the
    row is re-run at full width and counted once."""
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch.hmm import NGCL, ViterbiAlignPath
    db, aligner, _ = stream_parts
    reads = simulate_reads(db.ptu, 4, seed=14)
    vps = pl.batch_find_seed_vpaths(db.hmm, db.csfm, reads, mode=NGCL)
    K = db.hmm.K
    vps[2] = [ViterbiAlignPath(K + 500, K + 520, 5, 25, 0, 0)]
    tracer.enable(True)
    alns = aligner.align_batch(reads, vps)
    assert all(a.is_valid() for a in alns)
    assert tracer.counts()["aln_reads"] == 4
    assert tracer.counts()["band_fail"] == 1


def wide_read(tree, seed):
    """700 consecutive bases of a leaf: more CS columns than the
    placer's window of 512."""
    rng = np.random.default_rng(seed)
    for u in rng.permutation(tree.num_nodes):
        if tree.is_leaf(int(u)) and tree.msa_id[int(u)] >= 0:
            codes = tree.seqs[int(u)]
            pos = np.nonzero(codes >= 0)[0]
            if len(pos) >= 800:
                return "".join("ACGT"[c] for c in codes[pos[50:750]])
    raise AssertionError("no leaf of 800 bases")


class Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record):
        self.lines.append((record.levelno, record.getMessage()))


@pytest.fixture(scope="module")
def cli_runs(db_prefix, tmp_path_factory):  # noqa: F811
    """assign -v on 31 reads and one wider than the placer's window,
    with the tracer off and on: (rows off, rows on, log lines on,
    counters on)."""
    from hmmufotu_tpu_torch.cli import assign
    from hmmufotu_tpu_torch.db import Database
    tree = Database.load(db_prefix).ptu
    reads = simulate_reads(tree, 31, seed=15)
    reads.insert(7, wide_read(tree, 15))
    d = tmp_path_factory.mktemp("trace_cli")
    fa = d / "reads.fasta"
    fa.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    logger = logging.getLogger(assign.__name__)
    was, level = trace.ON, logger.level
    out = []
    try:
        for on in (False, True):
            trace.enable(on)
            trace.reset()
            lines = Lines()
            logger.addHandler(lines)
            logger.setLevel(logging.DEBUG)
            try:
                # the rows file's name is the same in both runs: the
                # header echoes the command
                path = d / "rows.tsv"
                assert assign.main([db_prefix, str(fa), "-b", "16", "-v",
                                    "-o", str(path)], device="cpu") == 0
                out.append((path.read_bytes(), lines.lines,
                            trace.counts()))
            finally:
                logger.removeHandler(lines)
    finally:
        logger.setLevel(level)
        trace.enable(was)
        trace.reset()
    (rows_off, log_off, cnt_off), (rows_on, log_on, cnt_on) = out
    assert cnt_off == {}
    assert not [m for _, m in log_off if m.startswith("trace:")]
    return rows_off, rows_on, log_on, cnt_on


def test_rows_are_byte_identical_with_tracing_on_and_off(cli_runs):
    rows_off, rows_on, _, _ = cli_runs
    assert rows_on == rows_off
    assert rows_on.count(b"\n") > 32


def test_a_read_wider_than_the_window_counts_and_warns(cli_runs):
    _, _, log_on, cnt = cli_runs
    assert cnt["window_clamped"] == 1
    warned = [m for lv, m in log_on if lv == logging.WARNING
              and "window of 512" in m]
    assert len(warned) == 1 and warned[0].startswith("1 reads")
    summary = [m for lv, m in log_on if m.startswith("trace:")]
    assert len(summary) == 1 and "batch" in summary[0]
    assert "window_clamped 1" in summary[0]


def test_clock_maps_main_thread_spans_onto_the_profiler_trace(tracer):
    tracer.enable(True)

    def work():
        for k in range(5):
            with tracer.span("batch", batch=k):
                with tracer.span("wait_seed"):
                    torch.ones(256, 256).sum()
        t = threading.Thread(target=lambda: tracer.span("dispatch")
                             .__enter__().__exit__(None, None, None))
        t.start()
        t.join(10)
        assert not t.is_alive()

    _, anns = profiled(work)
    recs = tracer.records()
    clock = tracer.trace_clock(anns, recs)
    assert clock is not None
    main = [r for r in recs if r.thread == threading.get_ident()]
    assert len(main) == 10 and all(r.profiled for r in main)
    # the profiler records no range opened on another thread
    assert not [r for r in recs if r.name == "dispatch"][0].profiled
    for name in ("batch", "wait_seed"):
        ev = sorted(e["ts"] for e in anns if e["name"] == name)
        mine = sorted(r.start_ns for r in main if r.name == name)
        assert len(ev) == len(mine) == 5
        for t, s in zip(ev, mine):
            assert abs(clock(s) - t) < 1000.0


def test_spans_and_counters_from_many_threads_lose_nothing(tracer):
    """More threads than cores, switching every microsecond: every span
    and every count is kept, each span under its own thread's parent."""
    n_threads, n = 4 * (os.cpu_count() or 2), 200
    tracer.enable(True)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(i):
        for _ in range(n):
            with tracer.span("outer", batch=i):
                with tracer.span("inner"):
                    tracer.count("hits")
                    tracer.count(f"hits{i % 3}", 2)

    try:
        ts = [threading.Thread(target=work, args=(i,))
              for i in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(switch)
    recs = tracer.records()
    cnt = tracer.counts()
    assert cnt["hits"] == n_threads * n
    assert sum(cnt[f"hits{j}"] for j in range(3)) == 2 * n_threads * n
    assert len(recs) == 2 * n_threads * n
    assert len({r.id for r in recs}) == len(recs)
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.name == "inner":
            up = by_id[r.parent]
            assert up.name == "outer" and up.thread == r.thread
            assert up.batch == r.batch
