"""The port's DevicePlacer end to end on the CPU: batched SEP placement
against the reference DevicePlacer on its fused-kernel branch
(sep_pallas=True, the Pallas kernels in interpret mode), and a
window-resident placer that routes an out-of-window read to the exact
host path.  Inputs and tolerances are those of test_torch_place.py."""

import numpy as np
import pytest

from test_torch_place import (BRANCH_ATOL, LL_ATOL, LL_RTOL,  # noqa: F401
                              leaf_reads, trees)
from test_torch_pipeline import one_torch_thread  # noqa: F401


def test_place_batch_matches_reference(trees):
    """[B, 12] summaries of the port's placer (device="cpu") against the
    reference: the same candidates and c/p/a nodes; branch lengths,
    logliks and heights within the tolerances; Q values, which
    exponentiate loglik differences between candidates, within 0.05."""
    from hmmufotu_tpu.phylo.placement import DevicePlacer as RefPlacer
    from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
    ref_tree, tree = trees
    seqs, starts, ends = leaf_reads(ref_tree, 6, seed=4)
    want = RefPlacer(ref_tree, window=256, max_nseed=8, sep_pallas=True
                     ).place_batch(seqs, starts, ends)
    got = DevicePlacer(tree, window=256, max_nseed=8, device="cpu"
                       ).place_batch(seqs, starts, ends)
    s_ref, s = np.asarray(want["summary"]), got["summary"]
    assert s.shape == s_ref.shape == (6, 12)
    np.testing.assert_array_equal(got["cand"], np.asarray(want["cand"]))
    np.testing.assert_array_equal(s[:, [0, 1, 2, 11]],
                                  s_ref[:, [0, 1, 2, 11]])
    np.testing.assert_allclose(s[:, [3, 4]], s_ref[:, [3, 4]],
                               atol=BRANCH_ATOL)
    np.testing.assert_allclose(s[:, 5], s_ref[:, 5], rtol=LL_RTOL,
                               atol=LL_ATOL)
    np.testing.assert_allclose(s[:, [6, 7]], s_ref[:, [6, 7]], atol=0.05)
    np.testing.assert_allclose(s[:, [8, 9, 10]], s_ref[:, [8, 9, 10]],
                               atol=BRANCH_ATOL)


def test_resident_window_routes_out_of_window_read(trees):
    """A window-resident placer raises OutOfWindowError on a read whose
    window leaves the resident span; dispatch_place_batch places that
    read on the exact host path instead, which agrees with the
    reference's host path, and the in-window reads exactly as the
    full-length placer does."""
    from hmmufotu_tpu import pipeline as ref_pl
    from hmmufotu_tpu.hmm.profile import HmmAlignment as RefAln
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch.hmm.profile import HmmAlignment
    from hmmufotu_tpu_torch.phylo.placement import (DevicePlacer,
                                                    OutOfWindowError)
    ref_tree, tree = trees
    seqs, starts, ends = leaf_reads(tree, 4, seed=8, length=150)
    # read 0 (the first 150 sites of node 1) lies before the resident
    # window, the others inside it
    seqs[0, :] = -2
    first = np.nonzero(tree.seqs[1] >= 0)[0][:150]
    seqs[0, first] = tree.seqs[1][first]
    starts[0], ends[0] = first[0], first[-1]
    s0 = int(starts[1:].min()) // 128 * 128
    assert starts[0] < s0
    window = (s0, tree.cs_len - s0)
    placer = DevicePlacer(tree, window=256, max_nseed=8, device="cpu",
                          site_window=window)
    with pytest.raises(OutOfWindowError) as ei:
        placer.place_batch(seqs, starts, ends)
    assert list(ei.value.rows) == [0]

    alns, ref_alns = [], []
    for r in range(len(seqs)):
        kw = dict(K=1, L=tree.cs_len, seq_start=1,
                  seq_end=int((seqs[r] >= 0).sum()), hmm_start=1,
                  hmm_end=1, cs_start=int(starts[r]) + 1,
                  cs_end=int(ends[r]) + 1, cost=1.0,
                  align="".join("ACGT"[c] if c >= 0 else "-"
                                for c in seqs[r]))
        alns.append(HmmAlignment(**kw))
        ref_alns.append(RefAln(**kw))
    got = pl.assign_batch_device(tree, placer, alns)
    full = pl.assign_batch_device(
        tree, DevicePlacer(tree, window=256, max_nseed=8, device="cpu"),
        alns)
    host = ref_pl.assign_read(ref_tree, ref_alns[0],
                              ref_pl.aln_to_digital(ref_tree, ref_alns[0]),
                              np.inf, np.inf, 8, 20.0)
    assert (got[0].c_node, got[0].p_node, got[0].a_node) == \
        (host.c_node, host.p_node, host.a_node)
    assert got[0].loglik == pytest.approx(host.loglik, rel=1e-12)
    for p, q in zip(got[1:], full[1:]):
        assert (p.c_node, p.p_node, p.a_node) == (q.c_node, q.p_node,
                                                  q.a_node)
        assert p.loglik == pytest.approx(q.loglik, rel=1e-5, abs=1e-3)
