"""The benchmark's copies of the kernels' work counters agree with
chip_smoke.py's operation counts on the same launches (recorded by the
k1_roofline and k3_roofline metrics' own wrappers from the plain
versions on the CPU), and count bytes from the algorithm's needs."""

import json
import os
import sys

import numpy as np

from conftest import REPO, run_cell


def launches_of_a_batch(checkout):
    sys.path.insert(0, checkout)
    from portbench import dbcache, harness, probes
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch.hmm import NGCL, ProfileHMM, ViterbiAligner
    from hmmufotu_tpu_torch.index import CSFMIndex
    from hmmufotu_tpu_torch.phylo import PTUnrooted
    from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
    cfg = json.load(open(os.path.join(checkout, "portbench", "configs",
                                      "tiny_dg4.json")))
    cache = dbcache.DbCache(cfg)
    if not cache.complete():
        assert run_cell(checkout, "tiny_dg4.se", 5, seconds=5)[0] == 0
    hmm = ProfileHMM.from_hmmer_file(cache.hmm)
    csfm = CSFMIndex.load(cache.csfm)
    tree = PTUnrooted.load(cache.ptu)
    tree.evaluate(dtype=np.float32, engine="torch", device="cpu")
    tree.msg_read_dtype = np.float64
    hmm.set_sequence_mode(NGCL)
    hmm.wing_retract()
    traffic = json.load(open(os.path.join(checkout, "portbench", "traffic",
                                          "tiny_se.json")))
    fwd, _ = harness.make_traffic(traffic, 9, 24,
                                  np.load(cache.inputs)["codes"])
    patches, stores = probes.Patches(), {"k1": {}, "k3": {}}
    for key in stores:
        probes.metric_module(checkout, key + "_roofline").install(
            patches, stores[key])
    try:
        aligner = ViterbiAligner(hmm, device="cpu")
        alns = pl.align_reads(aligner, csfm, [r.seq for r in fwd], mode=NGCL)
        placer = DevicePlacer(tree, device="cpu")
        pl.assign_batch_device(tree, placer, alns)
    finally:
        patches.undo()
    return {key: store["launches"] for key, store in stores.items()}


def test_counts_match_chip_smoke(checkout):
    sys.path.insert(0, REPO)
    import chip_smoke
    import torch
    from portbench import work
    from hmmufotu_tpu_torch.hmm.viterbi import MAX_REGIONS, REGION_WIDTH
    launches = launches_of_a_batch(checkout)
    assert launches["k1"] and launches["k3"]
    for meta, n_rows, K, n_regions in launches["k1"]:
        nr = n_regions or MAX_REGIONS
        b, ops = work.k1_work(meta.numpy(), n_rows, K, nr, MAX_REGIONS,
                              REGION_WIDTH)
        assert ops == chip_smoke.K1_OPS_PER_CELL * chip_smoke.dp_cells(
            meta, n_rows, K, nr)
        # bytes: tables, one byte a base, the bands and the path
        assert b < 8 * (K + 1) * 17 + 64 * int(meta[:, 0].sum()) + 10 ** 6
    for sites, live, n_rates, outer, inner in launches["k3"]:
        b, ops = work.k3_work(sites.numpy(), live.numpy(), n_rates,
                              outer.numpy(), inner.numpy())
        M = live.numel()
        _, want = chip_smoke.k3_work(sites, live.bool(), n_rates, outer,
                                     inner, 0, M)
        assert np.isclose(ops, want, rtol=1e-12)
        n_sites = float(sites[live.bool()].sum())
        assert b >= n_sites * 3 * 4 * 4


def test_roofline_share():
    from portbench.work import (PEAK_BYTES_S, PEAK_F32_OPS_S,
                                roofline_pct)
    pct, bound = roofline_pct(PEAK_BYTES_S, 1.0, 2.0)
    assert bound == "bytes" and abs(pct - 50.0) < 1e-9
    pct, bound = roofline_pct(1.0, PEAK_F32_OPS_S, 4.0)
    assert bound == "operations" and abs(pct - 25.0) < 1e-9
