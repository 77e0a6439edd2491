"""Paired-end assign at the gg_97 harness's shape (BASELINE config #4),
small, on the CPU: scripts/torch_scale_e2e.py --paired against the
reference package.

The harness drives the port's assign CLI batch loop on 2 x 250 bp mates
of leaf fragments of 500 +- 30 columns, so that about a third of the
merged pairs are wider than the placer's W = 512 columns.  Its device
rows are held against the reference package's assign_batch_device on the
same merged alignments (the reference's placer on the CPU, as
tests/test_scale.py runs it; rows by test_torch_scale.assert_rows_agree:
logliks within 8 f32 ulps, at most a quarter on another c node within
them; where a candidate sits at the estimate filter's edge, the port's
row held against the reference's exact host path instead), its gated parity against the exact host path on the alignments
clipped to the device's window must reach 95%, and with --mesh the
passes over eight CPU shards must give the rows of the passes without
it.  The clipping helper itself is held against the port's device placer
on a hand-made wide alignment, within the tolerances of
tests/test_torch_cli_pe.py."""

import json
import math
import os
import sys

import numpy as np
import pytest

from test_torch_pipeline import LL_ATOL, LL_RTOL, one_torch_thread  # noqa
from test_torch_scale import ULPS8, assert_rows_agree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
LEAVES, LENGTH, PAIRS, BATCH = 300, 1200, 64, 32
PAIRED = ["--leaves", str(LEAVES), "--length", str(LENGTH), "--reads",
          str(PAIRS), "--batch", str(BATCH), "--parity", "16", "--repeat",
          "1", "--paired", "--mesh", "--device", "cpu", "--cache", ""]

# Runs the port's harness (argv: the harness's path and arguments) and
# prints, after its JSON line, each placement call of the CLI's batch loop
# made without a mesh: the merged alignments' fields and the device's
# [c_node, loglik] rows.
RECORD_PE = r"""
import dataclasses, json, os, runpy, sys
import hmmufotu_tpu_torch.pipeline as pl
calls = []
place = pl.assign_batch_device

def assign_batch_device(tree, placer, alns, *a, **kw):
    best = place(tree, placer, alns, *a, **kw)
    if kw.get("mesh") is None:
        calls.append({
            "alns": [dataclasses.asdict(x) for x in alns],
            "rows": [None if b is None else [int(b.c_node), float(b.loglik)]
                     for b in best]})
    return best

pl.assign_batch_device = assign_batch_device
script = sys.argv[1]
sys.path.insert(0, os.path.dirname(script))
sys.argv = [script] + sys.argv[2:]
try:
    runpy.run_path(script, run_name="__main__")
    rc = 0
except SystemExit as e:
    rc = e.code or 0
sys.stdout.flush()
print(json.dumps(calls))
sys.exit(rc)
"""


@pytest.fixture(scope="module")
def scripts_path():
    sys.path.insert(0, SCRIPTS)
    yield
    sys.path.remove(SCRIPTS)


@pytest.fixture(scope="module")
def paired_run():
    """The harness's JSON line and the placement calls of its last pass
    without a mesh (one a batch)."""
    import subprocess
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("HMMUFOTU_TIMING", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", RECORD_PE,
         os.path.join(SCRIPTS, "torch_scale_e2e.py")] + PAIRED, env=env,
        cwd=REPO, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    lines = out.strip().splitlines()
    res, calls = json.loads(lines[-2]), json.loads(lines[-1])
    n_batches = -(-PAIRS // BATCH)
    return res, calls[-n_batches:]


def reference_placer():
    """The reference package's tree of the harness's shape (its own
    synth_tree and model, the jax evaluate engine on every column,
    ancestral sequences) and its device placer on the CPU."""
    sys.path.insert(0, SCRIPTS)
    try:
        from scale_eval import synth_tree
    finally:
        sys.path.remove(SCRIPTS)
    from hmmufotu_tpu.phylo.models import load_model
    from hmmufotu_tpu.phylo.placement import DevicePlacer
    tree = synth_tree(LEAVES, LENGTH, 0)
    tree.model = load_model(os.path.join(
        REPO, "hmmufotu_tpu", "data", "gg_97_otus_GTR.sm"))
    tree.anno = [f"k__K;g__g{u % 97}" for u in range(tree.num_nodes)]
    tree.evaluate(dtype=np.float32, engine="jax", budget_bytes=4 << 30)
    tree.infer_seq()
    return tree, DevicePlacer(tree, window=512, max_nseed=50)


def row(p):
    return None if p is None else [int(p.c_node), float(p.loglik)]


def test_paired_rows_match_reference(paired_run):
    """The harness's device rows against the reference package's
    assign_batch_device on the same merged alignments, batch for batch;
    the gated parity (alignments clipped to the device's window) at
    least 95% by both rules; some pairs wider than W among them."""
    from hmmufotu_tpu import pipeline as rpl
    from hmmufotu_tpu.hmm import HmmAlignment
    res, calls = paired_run
    tree, placer = reference_placer()
    want, got, alns = [], [], []
    for call in calls:
        batch = [HmmAlignment(**a) for a in call["alns"]]
        want += [row(b) for b in rpl.assign_batch_device(tree, placer,
                                                         batch)]
        got += call["rows"]
        alns += batch
    assert len(got) == PAIRS
    # a candidate whose estimate lies at the filter's edge (max_error
    # below the best estimate, within an f32 ulp) can be optimized by one
    # package's device placer and dropped by the other's, whose messages
    # come from another evaluate engine; there the port's row must be the
    # exact host path's (the reference package's assign_read), and no
    # more than one such row in 32 is allowed
    edge = [r for r, (w, g) in enumerate(zip(want, got))
            if w is not None and g is not None
            and abs(g[1] - w[1]) > ULPS8 * abs(w[1])]
    assert len(edge) <= PAIRS // 32, edge
    for r in edge:
        host = row(rpl.assign_read(tree, alns[r], rpl.aln_to_digital(
            tree, alns[r])))
        assert abs(got[r][1] - host[1]) <= ULPS8 * abs(host[1]), \
            (r, got[r], host, want[r])
        want[r] = host
    assert_rows_agree(want, got, 0.25)
    assert res["paired"] and res["whole_tree"]
    assert res["pairs"] == PAIRS == res["pairs_merged"] \
        + res["pairs_badly_oriented"]
    assert res["pairs_placed"] == sum(r is not None for r in got)
    n = res["parity_clip_reads"]
    assert n > 0
    assert min(res["parity_clip_cnode_match"],
               res["parity_clip_loglik_match"]) >= 0.95 * n
    assert res["merged_wider_than_W"] > 0
    assert res["parity_clip_span_gt_W"] == res["parity_full_wide_reads"] > 0
    assert res["parity_full_narrow_reads"] + res["parity_full_wide_reads"] \
        == n
    assert set(res["stages_s"]) == {"seed_search", "align", "merge_orient",
                                    "placement", "tsv"}
    assert res["pairs_per_s"] == float(np.median(res["pairs_per_s_runs"]))
    assert res["mates_per_s"] == 2 * res["pairs_per_s"]
    assert res["card_busy_ms"] is None and res["device_peak_gb"] is None


def test_paired_mesh_rows_equal(paired_run):
    """--mesh: the same passes over make_mesh(device="cpu"), eight CPU
    shards, give the rows of the passes without it, bit for bit."""
    res, _ = paired_run
    assert res["mesh_shards"] == 8 and res["mesh_devices"] == ["cpu"]
    assert res["mesh_rows_equal"] is True
    assert res["mesh_pairs_per_s"] > 0 and res["t_replicas_s"] >= 0


def test_simulate_pairs(scripts_path):
    """Each pair is one leaf fragment inside the span: the forward mate
    its first bases, the reverse mate the reverse complement of its
    last, each base the leaf's own but for the 2% substitutions."""
    from torch_scale_e2e import simulate_pairs
    from torch_scale_eval import synth_tree
    from hmmufotu_tpu_torch.alphabet import DNA
    tree = synth_tree(60, 1200, 3)
    lo, hi = 100, 1100
    fwd, rev, cols, leaf_ids = simulate_pairs(
        tree, 40, lo, hi, 250, np.random.default_rng(4), 500.0, 30.0)
    assert len(fwd) == len(rev) == 40
    assert (cols[:, 0] >= lo).all() and (cols[:, 1] < hi).all()
    widths = cols[:, 1] - cols[:, 0] + 1
    assert widths.max() > 512 and widths.min() < 512
    n_diff = n_all = 0
    for r, (f, m) in enumerate(zip(fwd, rev)):
        assert len(f.seq) == len(m.seq) == 250 and f.id == m.id
        codes = tree.seqs[leaf_ids[r], cols[r, 0]:cols[r, 1] + 1]
        leaf = "".join("ACGT"[c] for c in codes[codes >= 0])
        for got, want in ((f.seq, leaf[:250]),
                          (DNA.revcom(m.seq), leaf[-250:])):
            n_diff += sum(a != b for a, b in zip(got, want))
            n_all += 250
    assert 0 < n_diff < 0.04 * n_all


@pytest.fixture(scope="module")
def small_placer(one_torch_thread):
    """A port tree of 60 leaves x 1,200 columns (the harness's synth_tree
    and model), evaluated, and its device placer on the CPU."""
    sys.path.insert(0, SCRIPTS)
    try:
        from torch_scale_assign import load_tree_model
        from torch_scale_eval import synth_tree
    finally:
        sys.path.remove(SCRIPTS)
    from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
    tree = synth_tree(60, 1200, 1)
    load_tree_model(tree, "GTR")
    leaf = int(np.nonzero(tree.has_seq)[0][7])
    codes = tree.seqs[leaf].copy()
    tree.evaluate(dtype=np.float32)
    tree.infer_seq()
    return tree, DevicePlacer(tree, window=512, device="cpu"), codes


def leaf_alignment(codes, lo, hi):
    """A valid alignment of a leaf's bases on 0-based columns [lo, hi)."""
    from hmmufotu_tpu_torch.hmm.profile import HmmAlignment
    L = len(codes)
    body = "".join("ACGT"[c] if c >= 0 else "-" for c in codes[lo:hi])
    n = sum(c >= 0 for c in codes[lo:hi])
    return HmmAlignment(K=L, L=L, seq_start=1, seq_end=n, hmm_start=lo + 1,
                        hmm_end=hi, cs_start=lo + 1, cs_end=hi, cost=1.0,
                        align="." * lo + body + "." * (L - hi))


@pytest.mark.parametrize("lo,hi", [(100, 760), (300, 1200), (40, 553)],
                         ids=["wide", "to-the-end", "one-over"])
def test_clip_to_device_window_wide(scripts_path, small_placer, lo, hi):
    """On an alignment wider than W, assign_read of the clipped copy is
    the device's row: the same c node, loglik within the tolerances of
    tests/test_torch_cli_pe.py; the copy keeps the columns [start, start
    + W - 1] and pads the rest."""
    from torch_scale_e2e import clip_to_device_window
    from hmmufotu_tpu_torch import pipeline as pl
    tree, placer, codes = small_placer
    W = placer.W
    aln = leaf_alignment(codes, lo, hi)
    clip = clip_to_device_window(aln, W)
    assert clip is not aln and clip.is_valid()
    assert (clip.cs_start, clip.cs_end) == (lo + 1, lo + W)
    assert clip.align[lo:lo + W] == aln.align[lo:lo + W]
    assert set(clip.align[:lo] + clip.align[lo + W:]) == {"."}
    assert aln.cs_end == hi and len(clip.align) == len(aln.align)
    dev = pl.assign_batch_device(tree, placer, [aln])[0]
    host = pl.assign_read(tree, clip, pl.aln_to_digital(tree, clip))
    assert dev is not None and host is not None
    assert dev.c_node == host.c_node
    assert dev.loglik == pytest.approx(host.loglik, rel=LL_RTOL,
                                       abs=LL_ATOL)
    # the whole alignment scores more sites: its loglik is another one
    full = pl.assign_read(tree, aln, pl.aln_to_digital(tree, aln))
    assert not math.isclose(full.loglik, host.loglik, rel_tol=LL_RTOL)


@pytest.mark.parametrize("lo,hi", [(100, 612), (300, 500)],
                         ids=["W-columns", "narrow"])
def test_clip_to_device_window_narrow(scripts_path, small_placer, lo, hi):
    """An alignment of at most W columns is its own clipped copy."""
    from torch_scale_e2e import clip_to_device_window
    from hmmufotu_tpu_torch.hmm.profile import HmmAlignment
    _, placer, codes = small_placer
    aln = leaf_alignment(codes, lo, hi)
    assert clip_to_device_window(aln, placer.W) is aln
    assert clip_to_device_window(HmmAlignment(), placer.W).is_valid() \
        is False
