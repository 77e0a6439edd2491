"""K1, the banded Viterbi DP with in-kernel traceback: the port's plain
PyTorch version (the CPU path of hmm/cuda_viterbi.py) against the
reference Pallas kernel in interpret mode, and the port's ViterbiAligner
against the reference's XLA scan aligner."""

import os

import numpy as np
import pytest
import torch

from test_torch_pipeline import one_torch_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module")
def ref():
    """Reference MSA, NGCL-mode HMM and CSFM index of the fixture."""
    from hmmufotu_tpu.hmm import NGCL, ProfileHMM
    from hmmufotu_tpu.index.csfm import CSFMIndex
    from hmmufotu_tpu.mathx.dirichlet import HmmPrior
    from hmmufotu_tpu.msa import MSA
    msa = MSA.load_fasta(os.path.join(FIXTURES, "70_otus.fasta"))
    msa.prune()
    hmm = ProfileHMM.build(msa, 0.5,
                           HmmPrior.load(os.path.join(FIXTURES,
                                                      "gg_97_otus.dm")))
    hmm.set_sequence_mode(NGCL)
    hmm.wing_retract()
    return msa, hmm, CSFMIndex.build(msa)


@pytest.fixture(scope="module")
def port():
    """The same three objects built by the port's own modules."""
    from hmmufotu_tpu_torch.hmm import NGCL, ProfileHMM
    from hmmufotu_tpu_torch.index.csfm import CSFMIndex
    from hmmufotu_tpu_torch.mathx.dirichlet import HmmPrior
    from hmmufotu_tpu_torch.msa import MSA
    msa = MSA.load_fasta(os.path.join(FIXTURES, "70_otus.fasta"))
    msa.prune()
    hmm = ProfileHMM.build(msa, 0.5,
                           HmmPrior.load(os.path.join(FIXTURES,
                                                      "gg_97_otus.dm")))
    hmm.set_sequence_mode(NGCL)
    hmm.wing_retract()
    return msa, hmm, CSFMIndex.build(msa)


def fixture_reads(msa, n, length, seed):
    rng = np.random.default_rng(seed)
    reads = []
    while len(reads) < n:
        codes = msa.ds_at(int(rng.integers(msa.num_seq)))
        pos = np.nonzero(codes >= 0)[0]
        st = int(rng.integers(0, max(1, len(pos) - length - 10)))
        piece = codes[pos[st:st + length]].copy()
        mut = rng.random(len(piece)) < 0.02
        piece[mut] = rng.integers(0, 4, int(mut.sum()))
        reads.append("".join("ACGT"[c] for c in piece))
    return reads


def dp_inputs(ref, reads, unseeded=(), mode=None):
    """codes/lengths/regions of a read batch as the aligners build them;
    rows in `unseeded` get full-DP regions (wide launches)."""
    from hmmufotu_tpu import pipeline as pl
    from hmmufotu_tpu.hmm import NGCL
    from hmmufotu_tpu.hmm.viterbi import banded_regions, full_dp_regions
    _, hmm, csfm = ref
    vp = pl.batch_find_seed_vpaths(hmm, csfm, reads, mode=mode or NGCL)
    n_rows = (max(len(s) for s in reads) + 7) // 8 * 8
    B = len(reads)
    codes = np.zeros((B, n_rows), np.int32)
    lengths = np.zeros(B, np.int32)
    regions = np.zeros((B, 5, 8), np.int32)
    for r, s in enumerate(reads):
        codes[r, :len(s)] = np.clip(hmm.abc.encode(s), 0, 3)
        lengths[r] = len(s)
        regions[r] = (banded_regions(vp[r], hmm.K, len(s))
                      if vp[r] and r not in unseeded
                      else full_dp_regions(n_rows, hmm.K))
    return codes, lengths, regions, n_rows


def both_combs(ref, codes, lengths, regions, n_rows):
    """(reference comb, port comb) of one batch."""
    from hmmufotu_tpu.hmm.pallas_viterbi import viterbi_pallas_traced_split
    from hmmufotu_tpu.hmm.viterbi import DeviceHMM as RefDH
    from hmmufotu_tpu_torch.convert import device_hmm_from_numpy
    from hmmufotu_tpu_torch.hmm import cuda_viterbi as cv
    dh = RefDH.from_profile(ref[1])
    _, c_ref = viterbi_pallas_traced_split(
        dh, codes.astype(np.int8), lengths, regions, n_rows, KB=384,
        wide_floor=8, interpret=True)
    staged = cv.stage_costs(device_hmm_from_numpy(
        {k: np.asarray(v) for k, v in dh._asdict().items()}, "cpu"))
    c_port = cv.viterbi_traced_split(staged, dh.K, codes, lengths, regions,
                                     n_rows)
    return np.asarray(c_ref), c_port.numpy()


def routing(ref, regions):
    """(n wide rows, region slots, dchain) the split routes a batch by."""
    from hmmufotu_tpu_torch.hmm.cuda_viterbi import (
        DEFAULT_BAND_LANES, _dchain_bound, _region_bucket)
    K = ref[1].K
    used = regions[:, :, 1] > 0
    jlo = np.where(used, np.maximum(regions[:, :, 0], 1),
                   np.int64(1) << 40).min(1)
    jhi = np.where(used, np.minimum(regions[:, :, 1], K), 0).max(1)
    wide = jhi - np.maximum(jlo - 1, 0) + 1 > DEFAULT_BAND_LANES
    return int(wide.sum()), _region_bucket(used), \
        _dchain_bound(regions, used, K)


# (reads, length, read seed, unseeded rows, seeding mode, expected
# routing); the comb must equal the reference bit for bit in every case:
# both compute the D chain with the same min-plus doubling, so no tie can
# differ
CASES = {
    "narrow": (8, 250, 1, (), "NGCL",
               lambda w, nr, dc: w == 0 and nr == 3 and dc == 1024),
    "narrow+wide": (16, 120, 11, (3, 9), "NGCL",
                    lambda w, nr, dc: w == 2 and dc == 1 << 30),
    "all-wide": (8, 96, 8, (0, 2, 4, 5, 7), "NGCL",
                 lambda w, nr, dc: w == 5),
    "5-regions": (8, 160, 9, (), "GLOBAL", lambda w, nr, dc: nr == 5),
    "dchain-64": (8, 60, 0, (), "NGCL",
                  lambda w, nr, dc: w == 0 and dc == 64),
    "dchain-256": (8, 80, 1, (), "NGCL",
                   lambda w, nr, dc: w == 0 and dc == 256),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_interpret(ref, case):
    from hmmufotu_tpu.hmm import GLOBAL, NGCL
    n, length, seed, unseeded, mode, expect = CASES[case]
    reads = fixture_reads(ref[0], n, length, seed)
    codes, lengths, regions, n_rows = dp_inputs(
        ref, reads, unseeded, GLOBAL if mode == "GLOBAL" else NGCL)
    lengths[1] -= 7                 # rows past a read's end stay dead
    assert expect(*routing(ref, regions)), routing(ref, regions)
    c_ref, c_port = both_combs(ref, codes, lengths, regions, n_rows)
    assert c_ref.shape == c_port.shape
    np.testing.assert_array_equal(c_port, c_ref)
    assert np.isfinite(c_port[:, 0].view(np.float32)).all()


def band_origin(regions, K):
    """Per read (band origin jb, band span) as the split computes them."""
    used = regions[:, :, 1] > 0
    jlo = np.where(used, np.maximum(regions[:, :, 0], 1),
                   np.int64(1) << 40).min(1)
    jhi = np.where(used, np.minimum(regions[:, :, 1], K), 0).max(1)
    jb = np.maximum(jlo - 1, 0)
    return jb.astype(np.int32), (jhi - jb + 1).max()


# The row loop's special shapes, band-relative: the D chain cut after 1, 2,
# 32 and 33 lanes (below, at and past a warp's reach) and unbounded; a band
# of 200 lanes (not a multiple of 32) held against the reference at 256,
# which must agree while every region fits in 200 lanes.  Read 0 has
# length 1 and read 2 stops inside the batch; the others fill n_rows.
ROW_SHAPES = {"dchain-1": (1, 256), "dchain-2": (2, 256),
              "dchain-32": (32, 256), "dchain-33": (33, 256),
              "dchain-unbounded": (1 << 30, 256),
              "band-200-lanes": (1 << 30, 200)}


@pytest.mark.parametrize("shape", list(ROW_SHAPES))
def test_plain_matches_pallas_row_shapes(ref, shape):
    import jax.numpy as jnp
    from hmmufotu_tpu.hmm.pallas_viterbi import viterbi_pallas_traced
    from hmmufotu_tpu.hmm.viterbi import DeviceHMM as RefDH
    from hmmufotu_tpu_torch.convert import device_hmm_from_numpy
    from hmmufotu_tpu_torch.hmm import cuda_viterbi as cv
    dchain, KP = ROW_SHAPES[shape]
    reads = fixture_reads(ref[0], 8, 64, seed=0)
    codes, lengths, regions, n_rows = dp_inputs(ref, reads)
    assert n_rows == 64
    lengths[0], lengths[2] = 1, 37
    dh = RefDH.from_profile(ref[1])
    jb, span = band_origin(regions, dh.K)
    assert span <= 200
    _, c_ref = viterbi_pallas_traced(
        dh, jnp.asarray(codes.astype(np.int8)), jnp.asarray(lengths),
        jnp.asarray(regions), n_rows, True, j_base=jnp.asarray(jb), KB=256,
        n_regions=3, dchain=dchain)
    tc, em, scal = cv.stage_costs(device_hmm_from_numpy(
        {k: np.asarray(v) for k, v in dh._asdict().items()}, "cpu"))
    _, max_steps, _ = cv.launch_shape(dh.K, n_rows, 256)
    c_port = cv.viterbi_traced(
        tc, em, scal, torch.from_numpy(codes),
        torch.from_numpy(cv.make_meta(lengths, regions)),
        torch.from_numpy(jb), n_rows, dh.K, KP, max_steps, 3, dchain)
    np.testing.assert_array_equal(c_port.numpy(), np.asarray(c_ref))
    best_i = c_port.numpy()[:, 1].view(np.float32)
    assert best_i[0] == 1 and best_i[2] <= 37


def test_unpack_emits_matches_reference():
    from hmmufotu_tpu.hmm.pallas_viterbi import unpack_emits as ref_unpack
    from hmmufotu_tpu_torch.hmm.cuda_viterbi import PAD_WORD, unpack_emits
    rng = np.random.default_rng(0)
    w = rng.integers(-2**31, 2**31, (4, 16), dtype=np.int64) \
        .astype(np.int32)
    w[:, -3:] = np.int32(np.uint32(PAD_WORD).view(np.int32))
    np.testing.assert_array_equal(unpack_emits(w), ref_unpack(w))


def test_aligner_matches_reference_scan(ref, port):
    """Alignment strings and bounds equal the reference's XLA scan
    aligner; a read whose banded DP finds no path is re-run as full DP
    by both.  Scores agree to 1e-6 relative: the scan sums the D chain
    sequentially, the kernels by doubling (parity rule 2), which moves
    a score by an ulp at most."""
    from hmmufotu_tpu import pipeline as ref_pl
    from hmmufotu_tpu.hmm import NGCL, ViterbiAligner as RefAligner
    from hmmufotu_tpu.hmm.profile import ViterbiAlignPath as RefVP
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch.hmm import ViterbiAligner, ViterbiAlignPath
    reads = fixture_reads(ref[0], 12, 150, seed=5)
    K = ref[1].K
    vp_ref = ref_pl.batch_find_seed_vpaths(ref[1], ref[2], reads, mode=NGCL)
    vp = pl.batch_find_seed_vpaths(port[1], port[2], reads, mode=NGCL)
    assert [[tuple(vars(p).values()) for p in v] for v in vp] == \
        [[tuple(vars(p).values()) for p in v] for v in vp_ref]
    # read 4: a seed band past the profile's end leaves no cell to align
    vp_ref[4] = [RefVP(K + 500, K + 520, 5, 25, 0, 0)]
    vp[4] = [ViterbiAlignPath(K + 500, K + 520, 5, 25, 0, 0)]
    vp[6] = vp_ref[6] = None        # unseeded: full DP
    want = RefAligner(ref[1], kernel="scan").align_batch(reads, vp_ref)
    aligner = ViterbiAligner(port[1], device="cpu")
    handle = aligner.dispatch_batch(reads, vp)
    assert not np.isfinite(handle[-1][4, 0].view(torch.float32).item())
    got = aligner.finalize_batch(handle)
    for r, (a, b) in enumerate(zip(got, want)):
        assert a.is_valid() and b.is_valid(), r
        assert a.align == b.align, r
        assert (a.seq_start, a.seq_end, a.hmm_start, a.hmm_end, a.cs_start,
                a.cs_end) == (b.seq_start, b.seq_end, b.hmm_start,
                              b.hmm_end, b.cs_start, b.cs_end), r
        assert a.cost == pytest.approx(b.cost, rel=1e-6), r
