"""The per-layer metrics that read the program's own tracer
(progtrace.py): printed by a traced run of the tiny cell and by no
plain one; read as None, without raising, from a program that has no
tracer; the device's idle share under the seed wait computed on the
calibrated clock; the metrics already there unchanged beside them."""

import sys
import types

import pytest

from conftest import REPO, run_cell

sys.path.insert(0, REPO)

from portbench import probes, progtrace  # noqa: E402

NEW = ["seed_wait_s_per_kread", "aln_encode_s_per_kread",
       "k1_wait_s_per_kread", "place_wait_s_per_kread", "seed_miss_pct",
       "band_fail_pct", "seed_cpu_pct", "idle_seed_wait_pct"]
OLD = ["db_load_s", "evaluate_upload_s", "seed_s_per_kread",
       "strings_s_per_kread", "place_host_s_per_kread", "rows_s_per_kread",
       "k1_roofline", "k3_roofline", "device_idle_pct"]


def test_traced_run_prints_the_tracer_metrics_and_a_plain_run_none(
        checkout):
    rc, res, err = run_cell(checkout, "tiny_dg4.se", 3_000_000_037,
                            trace=1)
    assert rc == 0, err[-3000:]
    got = res["metrics"]
    # no device trace on the CPU: the idle share has nothing to read
    for name in NEW[:-1]:
        assert name in got, name
        assert got[name]["value"] >= 0
    assert "idle_seed_wait_pct" not in got
    assert got["seed_miss_pct"]["value"] <= 100
    assert 0 < got["seed_cpu_pct"]["value"] <= 105
    assert {"seed_s_per_kread", "strings_s_per_kread"} <= set(got)
    rc, res, err = run_cell(checkout, "tiny_dg4.se", 3_000_000_041,
                            trace=0)
    assert rc == 0, err[-3000:]
    assert not set(res["metrics"]) & set(NEW)


def fixed_run():
    """A traced window's record as harness.Window leaves it."""
    return dict(cell="gg97_dg4.se250_v4", rows=40960, window_s=30.5,
                setup={"db_load_s": 49.7, "evaluate_upload_s": 55.2},
                spans={"seed": 21.0, "strings": 16.3, "place": 6.0,
                       "rows": 0.54},
                calls={"seed": 21, "strings": 20, "place": 41, "rows": 80},
                device="cuda", busy_s=5.0, trace_window_s=30.4,
                kernel_s={"k1": 0.25, "k3": 0.17})


def read_all(inst, names, run):
    return {n: inst.read(n, run) for n in names}


def test_the_metrics_there_before_read_as_before_beside_the_new():
    """The nine read the same numbers from a fixed record whether or not
    the eight are installed beside them, and the eight's patches come
    off with the window's undo."""
    import torch.profiler as tp

    from hmmufotu_tpu_torch.utils import trace
    bench = [{"name": n} for n in OLD]
    alone = probes.Instruments(REPO, bench)
    run = fixed_run()
    before = read_all(alone, OLD, run)
    assert before["seed_s_per_kread"] == pytest.approx(1000 * 21.0 / 40960)
    assert before["device_idle_pct"] == pytest.approx(
        100 * (1 - 5.0 / 30.4))
    profile, on = tp.profile, trace.ON
    both = probes.Instruments(REPO, bench + [{"name": n} for n in NEW])
    # the eight's own installs only: the nine's wrappers need the program
    for name in NEW:
        both.mods[name].install(both.patches, both.stores[name])
    assert trace.ON and tp.profile is not profile
    both.undo()
    assert trace.ON == on and tp.profile is profile
    assert read_all(both, OLD, run) == before


def test_a_program_without_the_tracer_reads_none(monkeypatch):
    """As the parent commit's program, which has no utils.trace."""
    import hmmufotu_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "hmmufotu_tpu_torch.utils.trace", None)
    inst = probes.Instruments(REPO, [{"name": n} for n in NEW])
    inst.install()
    try:
        assert all(inst.stores[n].get("trace") is None for n in NEW)
    finally:
        inst.undo()
    run = dict(fixed_run())
    for name in NEW:
        assert inst.read(name, run) is None, name


def test_idle_and_overlap():
    busy = [(10.0, 20.0), (30.0, 35.0), (50.0, 60.0)]
    assert progtrace.idle(busy, 0.0, 70.0) == [
        (0.0, 10.0), (20.0, 30.0), (35.0, 50.0), (60.0, 70.0)]
    assert progtrace.idle(busy, 10.0, 60.0) == [(20.0, 30.0), (35.0, 50.0)]
    assert progtrace.overlap([(0.0, 10.0), (20.0, 30.0)],
                             [(5.0, 25.0), (29.0, 40.0)]) == 11.0


def span(i, name, start_us, end_us, profiled=True):
    from hmmufotu_tpu_torch.utils.trace import Span
    return Span(i, name, 0, None, 1, int(start_us * 1e3),
                int(end_us * 1e3), 0, profiled)


def test_idle_seed_wait_on_the_calibrated_clock():
    """Spans on a clock 1,000 us behind the trace's: the waits fall in
    the device's idle gaps only once mapped."""
    from hmmufotu_tpu_torch.utils import trace
    recs = [span(0, "batch", 0, 40), span(1, "wait_seed", 0, 10),
            span(2, "batch", 50, 90), span(3, "wait_seed", 50, 55),
            span(4, "seed", 60, 80, profiled=False)]
    fake = types.SimpleNamespace(records=lambda: recs,
                                 trace_clock=trace.trace_clock)
    store = dict(trace=fake,
                 annotations=[dict(name=r.name, ts=r.start_ns / 1e3 + 1000,
                                   dur=0.0, tid=1) for r in recs
                              if r.profiled],
                 busy=[[1010.0, 1050.0], [1055.0, 1100.0]],
                 window=(1000.0, 1100.0))
    mod = probes.metric_module(REPO, "idle_seed_wait_pct")
    # idle: [1000, 1010) and [1050, 1055); waits [1000, 1010), [1050, 1055)
    assert mod.read(dict(store=store)) == pytest.approx(100.0)
    store["busy"] = [[1000.0, 1005.0], [1050.0, 1100.0]]
    # idle: [1005, 1050): 45 us, of which the first wait covers 5
    assert mod.read(dict(store=store)) == pytest.approx(100 * 5 / 45)


def test_counter_shares_and_cpu_share():
    from hmmufotu_tpu_torch.utils.trace import Span
    counts = {"seed_reads": 200, "seed_miss": 3, "aln_reads": 200,
              "band_fail": 0}
    recs = [Span(0, "seed", 0, None, 2, 0, 2_000_000, 1_500_000, False),
            Span(1, "seed", 1, None, 2, 0, 2_000_000, 500_000, False)]
    fake = types.SimpleNamespace(counts=lambda: counts,
                                 records=lambda: recs)
    run = dict(rows=200, store=dict(trace=fake))
    read = lambda n: probes.metric_module(REPO, n).read(run)  # noqa: E731
    assert read("seed_miss_pct") == pytest.approx(1.5)
    assert read("band_fail_pct") == 0.0
    assert read("seed_cpu_pct") == pytest.approx(50.0)
    assert read("seed_wait_s_per_kread") is None


@pytest.mark.cuda
def test_tiny_cell_on_the_card_reads_every_tracer_metric(checkout, card):
    rc, res, err = run_cell(checkout, "tiny_dg4.se", 3_000_000_047,
                            device="cuda", trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, res["checks"]
    got = res["metrics"]
    for name in NEW:
        assert name in got, name
    assert 0 <= got["idle_seed_wait_pct"]["value"] <= 100
