"""The port's gg_97-shape harnesses (scripts/torch_scale_*.py) against the
reference package's (scripts/scale_*.py) at small shapes on the CPU, and
the aligner's stage clocks (hmm.viterbi.TIMING) against the reference
package's.

The synthetic tree and the simulated reads are equal array for array.
The harnesses run as processes: the reference's with JAX on the CPU, the
port's with --device cpu.  Tolerances: the tree loglik of the torch
evaluate engine within 1e-5 relative of the jax engine's (the tolerance
of tests/test_scale_eval.py between the reference package's engines);
placements agree with the exact host path for at least 95% of the
checked reads (the harnesses' own gate), and the counts of reads,
alignments, placements and host fallbacks are equal.  The placement
harnesses also run under a recorder that prints each checked read's
best c node and loglik, from the device and from the exact host path,
and the two packages' rows are held read for read: logliks within 8 f32
ulps (the harnesses' tie rule), the host path's c nodes equal, and at
most a quarter of the device's on another c node within those ulps (the
near-tie allowance of the synthetic DB in chip_smoke.py)."""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_pipeline import one_torch_thread  # noqa: F401
from test_torch_viterbi import fixture_reads, port, ref  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
LL_RTOL = 1e-5
TRACED_KEYS = {"dp_dispatch", "dp", "scalars_dl", "trace_dl", "host_build"}
ULPS8 = 8 * 2.0 ** -23       # the harnesses' tie rule, relative

# Runs a harness (argv: package, script, the harness's arguments) and
# prints, after its JSON line, the [c_node, loglik] rows of its last
# assign_stream ("stream") and its last place_batch_win ("win"), and of
# the exact host path's best placement after them: assign_read's calls
# with max_nseed (the parity check's, not the fallbacks'; "host") and the
# place lists that calc_q_values saw, sorted by the harness ("places").
RECORD = r"""
import importlib, json, os, runpy, sys
import numpy as np
pkg, script = sys.argv[1], sys.argv[2]
pl = importlib.import_module(pkg + ".pipeline")
Placer = importlib.import_module(pkg + ".phylo.placement").DevicePlacer
rec = {"stream": [], "win": [], "host": [], "places": []}
stream, assign_read, calc_q = pl.assign_stream, pl.assign_read, pl.calc_q_values
place_win = Placer.place_batch_win

def row(p):
    return None if p is None else [int(p.c_node), float(p.loglik)]

def assign_stream(*a, **kw):
    rec["stream"] = []
    for alns, best in stream(*a, **kw):
        rec["stream"] += [row(b) for b in best]
        yield alns, best

def assign_read_(*a, **kw):
    host = assign_read(*a, **kw)
    if "max_nseed" in kw:
        rec["host"].append(row(host))
    return host

def calc_q_values(tree, places, *a, **kw):
    rec["places"].append(places)
    return calc_q(tree, places, *a, **kw)

def place_batch_win(self, *a, **kw):
    out = place_win(self, *a, **kw)
    rec["places"] = []
    rec["win"] = [[int(r[0]), float(r[5])]
                  for r in np.asarray(out["summary"])]
    return out

pl.assign_stream, pl.assign_read = assign_stream, assign_read_
pl.calc_q_values, Placer.place_batch_win = calc_q_values, place_batch_win
sys.path.insert(0, os.path.dirname(script))
sys.argv = [script] + sys.argv[3:]
try:
    runpy.run_path(script, run_name="__main__")
    rc = 0
except SystemExit as e:
    rc = e.code or 0
sys.stdout.flush()
rec["places"] = [row(p[0]) for p in rec["places"]]
print(json.dumps(rec))
sys.exit(rc)
"""


def start(script, args, record=None):
    """Start a harness; the reference's with JAX on the CPU, the port's
    on one torch thread (the suite runs test files side by side).  With
    record (the harness's package), under RECORD."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    env.pop("HMMUFOTU_TIMING", None)
    path = os.path.join(SCRIPTS, script)
    cmd = ([sys.executable, "-c", RECORD, record, path] if record
           else [sys.executable, path])
    return subprocess.Popen(cmd + args, env=env, cwd=REPO, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def result(proc, want_rc=0):
    """The last JSON line a harness printed, and its stderr."""
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == want_rc, err[-3000:]
    return json.loads(out.strip().splitlines()[-1]), err


def recorded(proc, want_rc=0):
    """The JSON line of a harness started with record, and the rows."""
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == want_rc, err[-3000:]
    lines = out.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1])


def assert_rows_agree(want, got, max_other_frac):
    """[c_node, loglik] rows of the two packages on the same reads:
    logliks within 8 f32 ulps, and at most max_other_frac of the reads
    on another c node."""
    assert len(got) == len(want) > 0
    n_other = 0
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if w is not None:
            assert abs(g[1] - w[1]) <= ULPS8 * abs(w[1]), (w, g)
            n_other += g[0] != w[0]
    assert n_other <= max_other_frac * len(want)


def run_both(ref_script, ref_args, port_script, port_args):
    ref, port = start(ref_script, ref_args), start(port_script, port_args)
    return result(ref)[0], result(port)[0]


# ---------------------------------------------------------------------------
# the synthetic inputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scripts_path():
    sys.path.insert(0, SCRIPTS)
    yield
    sys.path.remove(SCRIPTS)


@pytest.mark.parametrize("seed", [0, 5])
def test_synth_tree_matches_reference(scripts_path, seed):
    from scale_eval import synth_tree as ref_synth
    from torch_scale_eval import synth_tree
    ref, got = ref_synth(40, 300, seed), synth_tree(40, 300, seed)
    assert got.num_nodes == ref.num_nodes == 79
    for k in ("cs_len", "root", "names", "anno"):
        assert getattr(got, k) == getattr(ref, k), k
    for k in ("parent", "brlen", "anno_dist", "heights", "msa_id", "seqs",
              "has_seq"):
        a, b = getattr(got, k), getattr(ref, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("seed", [0, 5])
def test_simulate_window_reads_matches_reference(scripts_path, seed):
    from scale_assign import simulate_window_reads as ref_sim
    from torch_scale_assign import simulate_window_reads
    from torch_scale_eval import synth_tree
    tree = synth_tree(60, 900, seed)
    got = simulate_window_reads(tree, 24, 128, 128 + 512, 250,
                                np.random.default_rng(seed + 1))
    want = ref_sim(tree, 24, 128, 128 + 512, 250,
                   np.random.default_rng(seed + 1))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the three harnesses against the reference's
# ---------------------------------------------------------------------------

def test_scale_eval_matches_reference():
    shape = ["--leaves", "200", "--length", "600", "--dgamma", "4"]
    ref, got = run_both("scale_eval.py", shape + ["--engine", "jax"],
                        "torch_scale_eval.py",
                        shape + ["--engine", "torch", "--device", "cpu"])
    assert ref["finite_ok"] and got["finite_ok"]
    assert got["n_nodes"] == ref["n_nodes"] == 399
    assert abs(got["tree_loglik"] - ref["tree_loglik"]) \
        <= LL_RTOL * abs(ref["tree_loglik"])
    assert got["device"] == "cpu" and got["card"] is None \
        and got["device_peak_gb"] is None


E2E = ["--leaves", "300", "--length", "1200", "--reads", "64", "--batch",
       "32", "--parity", "16"]


@pytest.mark.parametrize("msg_dtype", ["f32", "bf16"])
def test_scale_e2e_matches_reference(msg_dtype):
    """Both harnesses on the same reads, the port's with K1's plain
    version (the traced aligner's five clocks).  bf16 message storage
    passes the reference's 8-ulp c-node count but not the port's loglik
    gate, and the port exits 1 on it."""
    args = E2E + ["--msg-dtype", msg_dtype]
    ref_proc = start("scale_e2e.py", args, record="hmmufotu_tpu")
    got_proc = start("torch_scale_e2e.py", args + [
        "--device", "cpu", "--repeat", "2", "--cache", ""],
        record="hmmufotu_tpu_torch")
    ref, ref_rows = recorded(ref_proc)
    got, rows = recorded(got_proc, want_rc=int(msg_dtype == "bf16"))
    for k in ("n_nodes", "K", "csfm_chars", "site_window", "reads_aligned",
              "reads_placed", "host_fallback_reads"):
        assert got[k] == ref[k], k
    assert set(ref["align_substages_s"]) == {"dp_dispatch", "dp",
                                             "scalars_dl"}
    assert set(got["align_substages_s"]) == TRACED_KEYS
    assert set(got["host_stages_s"]) == {"seed_search", "host_fallback"}
    for r in (ref, got):
        assert r["parity_cnode_match"] >= 0.95 * r["parity_reads"] > 0
    assert got["parity_cnode_exact"] <= got["parity_cnode_match"]
    ll_ok = got["parity_loglik_match"] >= 0.95 * got["parity_reads"]
    assert ll_ok == (msg_dtype == "f32")
    assert_rows_agree(ref_rows["stream"], rows["stream"], 0.25)
    assert_rows_agree(ref_rows["host"], rows["host"], 0.0)
    assert len(rows["host"]) == got["parity_reads"]
    assert len(got["reads_per_s_runs"]) == 2
    assert got["reads_per_s"] == float(np.median(got["reads_per_s_runs"]))
    assert got["reads_per_s_spread"] == [min(got["reads_per_s_runs"]),
                                         max(got["reads_per_s_runs"])]
    assert got["host_fallback_reads_runs"] == [ref["host_fallback_reads"]] * 2
    assert got["card"] is None and got["peak_rss_gb"] > 0


def test_scale_e2e_whole_tree_matches_reference():
    """--whole-tree (every column evaluated, the whole tree's messages on
    the device, no site window) against the reference script whose site
    window is the whole width (--span 1200 of 1,200 columns): the same
    reads, placed by both without the exact host path."""
    args = E2E + ["--span", "1200"]
    ref_proc = start("scale_e2e.py", args, record="hmmufotu_tpu")
    got_proc = start("torch_scale_e2e.py", args + [
        "--whole-tree", "--device", "cpu", "--repeat", "1", "--cache", ""],
        record="hmmufotu_tpu_torch")
    ref, ref_rows = recorded(ref_proc)
    got, rows = recorded(got_proc)
    assert ref["site_window"] == got["site_window"] == [0, 1200]
    assert got["whole_tree"] is True
    for k in ("n_nodes", "K", "csfm_chars", "reads_aligned",
              "reads_placed"):
        assert got[k] == ref[k], k
    assert ref["host_fallback_reads"] == got["host_fallback_reads"] == 0
    # no read leaves a span of the whole width
    assert got["parity_oow_reads"] == 0
    for r in (ref, got):
        assert r["parity_cnode_match"] >= 0.95 * r["parity_reads"] > 0
    assert got["parity_loglik_match"] >= 0.95 * got["parity_reads"]
    assert_rows_agree(ref_rows["stream"], rows["stream"], 0.25)
    assert_rows_agree(ref_rows["host"], rows["host"], 0.0)
    # the whole tree's messages: 2 x [599, 4, 1200] f32 and more
    assert got["db_resident_gb"] > 2 * 599 * 4 * 1200 * 4 / 1e9


def test_out_of_window_rule_matches_dispatch(scripts_path):
    """The reads torch_scale_e2e.py holds against the host path under
    --whole-tree are those pipeline.dispatch_place_batch routes to it for
    a window-resident placer of the same span."""
    from torch_scale_e2e import out_of_window
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch.hmm.profile import HmmAlignment

    class Placer:        # what dispatch_place_batch reads of a placer
        site_window, W, C, ref_rank = (128, 512), 256, 5, False
        start_bound = 128 + 512 - 256
        seen = None

        def dispatch_win(self, seqs, starts, *a, **kw):
            Placer.seen = np.asarray(starts)
            return {"summary": None}

    routed = []
    alns = []
    # 1-based; the window covers [start, min(end, start + 255)] of the
    # 0-based columns, and must lie in [128, 640)
    for cs_start, cs_end in ((100, 300), (129, 380), (500, 900), (129, 640),
                             (390, 700), (400, 600)):
        a = HmmAlignment()
        a.seq_start, a.seq_end, a.hmm_start, a.hmm_end = 1, 2, 1, 2
        a.K, a.L, a.cs_start, a.cs_end = 9, 1200, cs_start, cs_end
        a.cost, a.align = 1.0, "-" * 1200
        alns.append(a)
    assert all(a.is_valid() for a in alns)
    orig = pl.assign_read, pl.aln_to_digital
    pl.assign_read = lambda tree, aln, *a, **kw: routed.append(aln)
    pl.aln_to_digital = lambda tree, aln: None
    try:
        pl.dispatch_place_batch(None, Placer(), alns)
    finally:
        pl.assign_read, pl.aln_to_digital = orig
    want = [i for i, a in enumerate(alns) if any(a is r for r in routed)]
    assert out_of_window(alns, 128, 512, 256) == want == [0, 2, 4]


ASSIGN = ["--leaves", "300", "--length", "1200", "--reads", "64", "--batch",
          "32", "--parity", "16"]


@pytest.mark.parametrize("msg_dtype", ["f32", "bf16"])
def test_scale_assign_matches_reference(msg_dtype):
    args = ASSIGN + ["--msg-dtype", msg_dtype]
    ref_proc = start("scale_assign.py", args, record="hmmufotu_tpu")
    got_proc = start("torch_scale_assign.py", args + ["--device", "cpu"],
                     record="hmmufotu_tpu_torch")
    (ref, ref_rows), (got, rows) = recorded(ref_proc), recorded(got_proc)
    for k in ("n_nodes", "site_window", "reads_placed", "parity_reads"):
        assert got[k] == ref[k], k
    for r in (ref, got):
        assert r["parity_cnode_match"] >= 0.95 * r["parity_reads"] > 0
    assert_rows_agree(ref_rows["win"], rows["win"], 0.25)
    assert_rows_agree(ref_rows["places"], rows["places"], 0.0)
    assert len(rows["places"]) == got["parity_reads"]
    assert got["db_resident_gb"] > 0 and got["device_peak_gb"] is None


def test_scale_assign_profile_on_cpu(tmp_path):
    got, err = result(start("torch_scale_assign.py", ASSIGN + [
        "--parity", "0", "--device", "cpu", "--profile", str(tmp_path)]))
    prof = got["profile"]
    assert os.path.getsize(prof["trace"]) > 0
    assert prof["time_of"] == "CPU" and len(prof["top_ops"]) > 0
    assert "profile (CPU time, self, top ops)" in err
    assert prof["top_ops"][0]["op"] in err


# ---------------------------------------------------------------------------
# the aligner's stage clocks
# ---------------------------------------------------------------------------

def timed_keys(monkeypatch, mod, aligner, pl, hmm, csfm, reads, on):
    """TIMING's keys after one batch through aligner, with the clocks on
    or off."""
    if on:
        monkeypatch.setenv("HMMUFOTU_TIMING", "1")
    else:
        monkeypatch.delenv("HMMUFOTU_TIMING", raising=False)
    mod.TIMING.clear()
    vp = pl.batch_find_seed_vpaths(hmm, csfm, reads, mode="ngcl")
    alns = aligner.finalize_batch(aligner.dispatch_batch(reads, vp))
    assert sum(a.is_valid() for a in alns) == len(reads)
    keys = set(mod.TIMING)
    mod.TIMING.clear()
    return keys


# (reference kernel, port kernel, traceback mode)
MODES = [("pallas", "cuda", "device"), ("pallas", "cuda", "host"),
         ("scan", "scan", "host"), ("scan", "scan", "device")]


@pytest.mark.parametrize("ref_kernel,kernel,tb", MODES)
def test_timing_keys_match_reference(monkeypatch, ref, port, ref_kernel,
                                     kernel, tb):
    """For each aligner mode the port ticks the reference package's keys
    under HMMUFOTU_TIMING=1 (the reference's Pallas kernels in interpret
    mode), and records nothing without it."""
    import hmmufotu_tpu.hmm.pallas_viterbi as rpv
    import hmmufotu_tpu.hmm.viterbi as rv
    from hmmufotu_tpu import pipeline as rpl
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch.hmm import ViterbiAligner
    from hmmufotu_tpu_torch.hmm import viterbi as v
    for name in ("viterbi_pallas", "viterbi_pallas_traced_split"):
        monkeypatch.setattr(rpv, name, functools.partial(
            getattr(rpv, name), interpret=True))
    (rmsa, rhmm, rcsfm), (_, hmm, csfm) = ref, port
    reads = fixture_reads(rmsa, 4, 96, seed=3)
    ref_al = rv.ViterbiAligner(rhmm, traceback_mode=tb, kernel=ref_kernel)
    al = ViterbiAligner(hmm, device="cpu", kernel=kernel, traceback_mode=tb)
    want = timed_keys(monkeypatch, rv, ref_al, rpl, rhmm, rcsfm, reads, True)
    got = timed_keys(monkeypatch, v, al, pl, hmm, csfm, reads, True)
    assert got == want
    assert "dp_dispatch" in got and "dp" in got
    if (kernel, tb) == ("cuda", "device"):
        assert got == TRACED_KEYS
    assert timed_keys(monkeypatch, v, al, pl, hmm, csfm, reads,
                      False) == set()
