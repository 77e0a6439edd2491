"""The aligner's other modes: viterbi_scan (the DP in plain tensor ops),
K4's plain version viterbi_planes_plain (the CPU path of
hmm/cuda_viterbi.viterbi_planes), the host and device tracebacks, and the
four ViterbiAligner modes, each against its counterpart in the reference
package on the same numpy-seeded inputs.  The reference's Pallas kernel
runs in interpret mode.

Tolerances.  viterbi_planes_plain against viterbi_pallas: bit-equal
(score, min_i, min_j and every packed plane word), since both run the
same min-plus doubling in the same order.  viterbi_scan against the
reference's viterbi_scan: score to 1e-6 relative, min_i/min_j equal,
choice planes differing in under 1e-4 of the cells, the bound the
reference holds between its own scan and kernel (tests/test_hmm.py): the
reference's scan sums the D chain in associative_scan's order, the
port's by doubling, which can flip a choice at an ulp-level cost tie.
Tracebacks over the same planes: exact."""

import functools

import numpy as np
import pytest
import torch

from test_torch_viterbi import (dp_inputs, fixture_reads, port,  # noqa: F401
                                ref)
from test_torch_pipeline import one_torch_thread  # noqa: F401

N_ROWS = 64


def _ref_dh(ref):
    from hmmufotu_tpu.hmm.viterbi import DeviceHMM as RefDH
    return RefDH.from_profile(ref[1])


def _port_dh(dh):
    from hmmufotu_tpu_torch.convert import device_hmm_from_numpy
    return device_hmm_from_numpy(
        {k: np.asarray(v) for k, v in dh._asdict().items()}, "cpu")


def _inputs(ref, case):
    """(codes, lengths, regions) of 8 reads x 64 rows: random bases as
    full DP, or fixture reads with their seed bands (two rows unseeded,
    one read shorter than the batch)."""
    from hmmufotu_tpu.hmm.viterbi import full_dp_regions
    K = ref[1].K
    if case == "full-dp":
        rng = np.random.default_rng(0)
        codes = rng.integers(0, 4, (8, N_ROWS)).astype(np.int32)
        lengths = np.full(8, N_ROWS, np.int32)
        lengths[3] = 40
        regions = np.tile(full_dp_regions(N_ROWS, K)[None], (8, 1, 1)) \
            .astype(np.int32)
        return codes, lengths, regions
    reads = fixture_reads(ref[0], 8, N_ROWS, seed=3)
    reads[1] = reads[1][:50]
    codes, lengths, regions, n_rows = dp_inputs(ref, reads, unseeded=(2, 5))
    assert n_rows == N_ROWS
    if case == "edge-lengths":
        # a read of one base beside reads that fill every row: the planes
        # past a read's end are output too
        lengths[0] = 1
        assert (lengths[3:] == N_ROWS).all()
    return codes, lengths, regions


@pytest.fixture(scope="module")
def planes(ref):
    """Per case: the inputs, the reference kernel's (score, min_i, min_j,
    packed) in interpret mode and the port's from viterbi_planes."""
    import jax.numpy as jnp
    from hmmufotu_tpu.hmm.pallas_viterbi import viterbi_pallas
    from hmmufotu_tpu_torch.hmm import cuda_viterbi as cv
    dh = _ref_dh(ref)
    staged = cv.stage_costs(_port_dh(dh))
    out = {}
    for case in ("full-dp", "banded", "edge-lengths"):
        codes, lengths, regions = _inputs(ref, case)
        want = tuple(np.array(x) for x in viterbi_pallas(
            dh, jnp.asarray(codes.astype(np.int8)), jnp.asarray(lengths),
            jnp.asarray(regions), N_ROWS, interpret=True))
        got = cv.viterbi_planes(
            *staged, torch.from_numpy(codes),
            torch.from_numpy(cv.make_meta(lengths, regions)), N_ROWS, dh.K)
        out[case] = ((codes, lengths, regions), want,
                     tuple(x.numpy() for x in got))
    return out


@pytest.mark.parametrize("case", ["full-dp", "banded", "edge-lengths"])
def test_planes_plain_matches_pallas_interpret(ref, planes, case):
    _, want, got = planes[case]
    K = ref[1].K
    KPF = (K + 2 + 127) // 128 * 128
    assert got[3].shape == want[3].shape == (N_ROWS // 8, 8, KPF)
    assert got[3].dtype == np.int32
    assert np.isfinite(want[0]).all()
    np.testing.assert_array_equal(got[0], want[0])          # bit-equal
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])


def test_planes_requires_rows_in_eights(ref):
    from hmmufotu_tpu_torch.hmm import cuda_viterbi as cv
    staged = cv.stage_costs(_port_dh(_ref_dh(ref)))
    codes = torch.zeros((2, 12), dtype=torch.int32)
    meta = torch.zeros((2, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 8"):
        cv.viterbi_planes(*staged, codes, meta, 12, ref[1].K)


@pytest.mark.parametrize("case", ["full-dp", "banded"])
def test_scan_matches_reference_scan(ref, case):
    import jax.numpy as jnp
    from hmmufotu_tpu.hmm.viterbi import viterbi_scan as ref_scan
    from hmmufotu_tpu_torch.hmm.viterbi import viterbi_scan
    dh = _ref_dh(ref)
    codes, lengths, regions = _inputs(ref, case)
    # the scan takes any row count: cut to 60 rows, not a multiple of 8
    n_rows = 60
    codes = codes[:, :n_rows]
    lengths = np.minimum(lengths, n_rows)
    s1, i1, j1, c1 = (np.asarray(x) for x in ref_scan(
        dh, jnp.asarray(codes.astype(np.int8)), jnp.asarray(lengths),
        jnp.asarray(regions), n_rows))
    s2, i2, j2, c2 = (x.numpy() for x in viterbi_scan(
        _port_dh(dh), torch.from_numpy(codes), torch.from_numpy(lengths),
        torch.from_numpy(regions), n_rows))
    assert c2.shape == c1.shape == (n_rows, 8, dh.K + 1)
    assert c2.dtype == np.uint8 and i2.dtype == np.int32
    assert np.isfinite(s1).all()
    np.testing.assert_allclose(s2, s1, rtol=1e-6)
    np.testing.assert_array_equal(i2, i1)
    np.testing.assert_array_equal(j2, j1)
    assert (c1 != c2).mean() < 1e-4


def test_scan_unreachable_band_is_infinite(ref):
    """A band past the profile's end leaves no cell: both scans report an
    infinite score at (min_i, min_j) = (1, 0)."""
    import jax.numpy as jnp
    from hmmufotu_tpu.hmm.viterbi import viterbi_scan as ref_scan
    from hmmufotu_tpu_torch.hmm.viterbi import viterbi_scan
    dh = _ref_dh(ref)
    codes, lengths, regions = _inputs(ref, "full-dp")
    codes, lengths, regions = codes[:2, :16], lengths[:2] * 0 + 16, \
        regions[:2].copy()
    regions[1, 0] = (dh.K + 500, dh.K + 520, 5, 25, 1, 0, 0, 0)
    want = [np.asarray(x) for x in ref_scan(
        dh, jnp.asarray(codes.astype(np.int8)), jnp.asarray(lengths),
        jnp.asarray(regions), 16)[:3]]
    got = [x.numpy() for x in viterbi_scan(
        _port_dh(dh), torch.from_numpy(codes), torch.from_numpy(lengths),
        torch.from_numpy(regions), 16)[:3]]
    assert np.isinf(got[0][1]) and np.isfinite(got[0][0])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("case", ["full-dp", "banded"])
def test_host_tracebacks_match_reference(ref, planes, case):
    """traceback_packed on the packed planes and traceback on the
    unpacked ones, against the reference's on the same planes; the
    unpack and the 2-cells-a-byte transfer packing as well."""
    from hmmufotu_tpu.hmm import pallas_viterbi as rpv
    from hmmufotu_tpu.hmm import viterbi as rv
    from hmmufotu_tpu_torch.hmm import cuda_viterbi as cv
    from hmmufotu_tpu_torch.hmm import viterbi as pv
    K = ref[1].K
    _, (_, mi, mj, packed), _ = planes[case]
    ch = cv.unpack_nibble_choices(packed, N_ROWS, K + 1)
    np.testing.assert_array_equal(
        ch, rpv.unpack_nibble_choices(packed, N_ROWS, K + 1))
    two = pv.pack_choices(torch.from_numpy(ch)).numpy()
    np.testing.assert_array_equal(
        two, np.asarray(rv.pack_choices(ch)))
    np.testing.assert_array_equal(pv.unpack_choices(two, K + 1), ch)
    for r in range(packed.shape[1]):
        want = rv.traceback_packed(packed, r, int(mi[r]), int(mj[r]), K)
        assert pv.traceback_packed(packed, r, int(mi[r]), int(mj[r]),
                                   K) == want
        assert pv.traceback(ch[:, r], int(mi[r]), int(mj[r]), K) == want
        assert want == rv.traceback(ch[:, r], int(mi[r]), int(mj[r]), K)
        assert want[0].startswith("B") and want[0].endswith("E")


@pytest.mark.parametrize("case", ["full-dp", "banded"])
def test_device_tracebacks_match_reference(ref, planes, case):
    import jax.numpy as jnp
    from hmmufotu_tpu.hmm import pallas_viterbi as rpv
    from hmmufotu_tpu.hmm import viterbi as rv
    from hmmufotu_tpu_torch.hmm import cuda_viterbi as cv
    from hmmufotu_tpu_torch.hmm import viterbi as pv
    K = ref[1].K
    _, (_, mi, mj, packed), _ = planes[case]
    max_steps = N_ROWS + K + 2
    t = torch.from_numpy
    want = [np.asarray(x) for x in rpv.traceback_device_packed(
        jnp.asarray(packed), jnp.asarray(mi), jnp.asarray(mj), K,
        max_steps)]
    got = [x.numpy() for x in cv.traceback_device_packed(
        t(packed), t(mi), t(mj), K, max_steps)]
    ch = cv.unpack_nibble_choices(packed, N_ROWS, K + 1)
    want_u = [np.asarray(x) for x in rv.traceback_device(
        jnp.asarray(ch), jnp.asarray(mi), jnp.asarray(mj), K, max_steps)]
    got_u = [x.numpy() for x in pv.traceback_device(
        t(np.ascontiguousarray(ch)), t(mi), t(mj), K, max_steps)]
    assert got[0].shape == (packed.shape[1], max_steps)
    assert (got[0] != 5).any()
    for a, b in zip(got + got_u, want + want_u):
        np.testing.assert_array_equal(a, b)


MODES = [("cuda", "device"), ("cuda", "host"), ("scan", "host"),
         ("scan", "device")]


@pytest.fixture(scope="module")
def mode_reads(ref, port):
    """8 fixture reads of 64 bases with their seed paths in both
    packages' types: read 2 unseeded (full DP), read 4 with a band past
    the profile's end, whose banded DP fails and is re-run."""
    from hmmufotu_tpu import pipeline as ref_pl
    from hmmufotu_tpu.hmm import NGCL
    from hmmufotu_tpu.hmm.profile import ViterbiAlignPath as RefVP
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch.hmm import ViterbiAlignPath
    reads = fixture_reads(ref[0], 8, N_ROWS, seed=6)
    K = ref[1].K
    vp_ref = ref_pl.batch_find_seed_vpaths(ref[1], ref[2], reads, mode=NGCL)
    vp = pl.batch_find_seed_vpaths(port[1], port[2], reads, mode=NGCL)
    assert sum(bool(v) for v in vp) >= 4
    vp_ref[4] = [RefVP(K + 500, K + 520, 5, 25, 0, 0)]
    vp[4] = [ViterbiAlignPath(K + 500, K + 520, 5, 25, 0, 0)]
    vp[2] = vp_ref[2] = None
    return reads, vp_ref, vp


@pytest.fixture(scope="module")
def default_alns(port, mode_reads):
    from hmmufotu_tpu_torch.hmm import ViterbiAligner
    reads, _, vp = mode_reads
    return ViterbiAligner(port[1], device="cpu").align_batch(reads, vp)


def _same_alignment(a, b, cost_rel):
    assert a.is_valid() and b.is_valid()
    assert a.align == b.align
    assert (a.seq_start, a.seq_end, a.hmm_start, a.hmm_end, a.cs_start,
            a.cs_end) == (b.seq_start, b.seq_end, b.hmm_start, b.hmm_end,
                          b.cs_start, b.cs_end)
    assert a.cost == pytest.approx(b.cost, rel=cost_rel)


@pytest.mark.parametrize("kernel,mode", MODES)
def test_aligner_mode_matches_reference(ref, port, mode_reads, default_alns,
                                        monkeypatch, kernel, mode):
    """Each mode gives the alignments of the reference ViterbiAligner in
    the same mode (its Pallas launches forced to interpret mode), and of
    the port's default mode.  Costs: equal between kernel modes, 1e-6
    relative against a scan (D-chain summation order)."""
    from hmmufotu_tpu.hmm import ViterbiAligner as RefAligner
    from hmmufotu_tpu.hmm import pallas_viterbi as rpv
    from hmmufotu_tpu_torch.hmm import ViterbiAligner
    reads, vp_ref, vp = mode_reads
    for name in ("viterbi_pallas", "viterbi_pallas_traced_split"):
        monkeypatch.setattr(rpv, name, functools.partial(
            getattr(rpv, name), interpret=True))
    want = RefAligner(ref[1], kernel="pallas" if kernel == "cuda" else "scan",
                      traceback_mode=mode).align_batch(reads, vp_ref)
    aligner = ViterbiAligner(port[1], device="cpu", kernel=kernel,
                             traceback_mode=mode)
    handle = aligner.dispatch_batch(reads, vp)
    got = aligner.finalize_batch(handle)
    assert len(got) == len(want) == len(reads)
    if not aligner.traced:
        # the failing band really failed in the first pass
        assert not np.isfinite(float(handle[-1][0][4]))
    for a, b, d in zip(got, want, default_alns):
        _same_alignment(a, b, 1e-6)
        _same_alignment(a, d, 0 if kernel == "cuda" else 1e-6)


def test_aligner_defaults_and_validation(port):
    from hmmufotu_tpu_torch.hmm import ViterbiAligner
    hmm = port[1]
    a = ViterbiAligner(hmm, device="cpu")
    assert (a.kernel, a.traceback_mode, a.traced) == ("cuda", "device", True)
    s = ViterbiAligner(hmm, device="cpu", kernel="scan")
    assert (s.traceback_mode, s.traced) == ("host", False)
    assert ViterbiAligner(hmm, device="cpu", kernel="scan") \
        .align_batch([]) == []
    with pytest.raises(ValueError, match="kernel"):
        ViterbiAligner(hmm, device="cpu", kernel="pallas")
    with pytest.raises(ValueError, match="traceback_mode"):
        ViterbiAligner(hmm, device="cpu", traceback_mode="kernel")
