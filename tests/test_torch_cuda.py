"""The CUDA kernels K1 to K5 against their plain PyTorch versions on the
same CUDA tensors, and their launch counters.  These tests need an
NVIDIA GPU (and nvcc, which builds the kernels at first use) and skip
without one; on a machine with a card run

    python -m pytest -m cuda tests/test_torch_cuda.py

They import nothing of JAX.  Tolerances: K1's comb and K4's planes are
bit-equal; K2 and K3 as in test_torch_place.py, since the kernels sum
sites in block reductions and the plain versions in torch's order; K5's
p within 1e-6 absolute + 1e-5 relative for the same reason (a lane may
also stop one step apart inside BRANCH_EPS of its limit).  Beside the
kernels: the torch evaluate engine on the card against the numpy f64
engine and its peak memory against its budget, paired-end assign on the
card against the port's CPU run, and sharded placement on four shards of
the card (and over every card of a host with several) against the
single-device placement, each shard's kernels on its own card."""

import os

import numpy as np
import pytest
import torch

from test_torch_pipeline import simulate_reads
from test_torch_place import (BRANCH_ATOL, LL_ATOL, LL_RTOL, est_args,
                              lane_inputs, model_inputs, port_lanes,
                              random_site_mask)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def db_prefix(cuda, tmp_path_factory):
    """The 70_otus GTR+dGamma4 DB built by the port's builder."""
    from hmmufotu_tpu_torch.cli.build import main as build_main
    prefix = str(tmp_path_factory.mktemp("db") / "70_otus")
    assert build_main([os.path.join(FIXTURES, "70_otus.fasta"),
                       os.path.join(FIXTURES, "70_otus.tree"),
                       "-a", os.path.join(FIXTURES, "70_otus_taxonomy.txt"),
                       "-n", prefix, "-s", "GTR", "-V"]) == 0
    return prefix


@pytest.fixture(scope="module")
def db(db_prefix):
    from hmmufotu_tpu_torch.db import Database
    from hmmufotu_tpu_torch.hmm import NGCL
    d = Database.load(db_prefix)
    d.hmm.set_sequence_mode(NGCL)
    d.hmm.wing_retract()
    return d


@pytest.mark.parametrize("unseeded", [(), (1, 5), tuple(range(12))])
def test_viterbi_kernel_matches_plain(db, unseeded):
    """Narrow launch only, narrow + wide split, and all wide."""
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch.hmm import NGCL, ViterbiAligner
    from hmmufotu_tpu_torch.hmm import cuda_viterbi as cv
    reads = simulate_reads(db.ptu, 16, seed=len(unseeded))
    vp = pl.batch_find_seed_vpaths(db.hmm, db.csfm, reads, mode=NGCL)
    for r in unseeded:
        vp[r] = None
    gpu = ViterbiAligner(db.hmm, device="cuda")
    cpu = ViterbiAligner(db.hmm, device="cpu")
    n0 = cv.viterbi_traced_cuda.launches.n
    hg = gpu.dispatch_batch(reads, vp)
    torch.cuda.synchronize()
    assert cv.viterbi_traced_cuda.launches.n > n0
    hc = cpu.dispatch_batch(reads, vp)
    assert torch.equal(hg[-1].cpu(), hc[-1])
    # the plain version on the same CUDA tensors
    tc, em, scal = gpu.staged
    KP, max_steps, _ = cv.launch_shape(db.hmm.K, hg[1], None)
    args = (tc, em, scal,
            torch.from_numpy(hg[2]).cuda(),
            torch.from_numpy(cv.make_meta(hg[3], hg[4])).cuda(),
            torch.zeros(len(reads), dtype=torch.int32, device="cuda"),
            hg[1], db.hmm.K, KP, max_steps)
    assert torch.equal(cv.viterbi_traced_cuda(*args),
                       cv.viterbi_traced_plain(*args))
    for a, b in zip(gpu.finalize_batch(hg), cpu.finalize_batch(hc)):
        assert (a.align, a.cost) == (b.align, b.cost)


WIDE_COLS = 6000       # the gg_97 shape's columns


@pytest.fixture(scope="module")
def wide_profile(cuda):
    """A synthetic profile of the gg_97 shape's 6,000 columns: 16 gapless
    rows, each a random root with 5% substitutions; its NGCL-mode HMM
    (K = 6,000, KPF = 6,016 lanes), CSFM index and rows."""
    from hmmufotu_tpu_torch.hmm import NGCL, ProfileHMM
    from hmmufotu_tpu_torch.index.csfm import CSFMIndex
    from hmmufotu_tpu_torch.mathx.dirichlet import HmmPrior
    from hmmufotu_tpu_torch.msa import MSA
    rng = np.random.default_rng(11)
    root = rng.integers(0, 4, WIDE_COLS)
    rows = np.stack([np.where(rng.random(WIDE_COLS) < 0.05,
                              rng.integers(0, 4, WIDE_COLS), root)
                     for _ in range(16)])
    chars = np.frombuffer(b"ACGT", np.uint8)[rows]
    msa = MSA.from_arrays([f"s{i}" for i in range(len(rows))], chars,
                          name="wide")
    hmm = ProfileHMM.build(msa, 0.5, HmmPrior.load(
        os.path.join(FIXTURES, "gg_97_otus.dm")))
    hmm.set_sequence_mode(NGCL)
    hmm.wing_retract()
    assert hmm.K == WIDE_COLS
    return hmm, CSFMIndex.build(msa), rows


def wide_reads(rows, n, seed, length):
    """Mutated (2%) windows of the wide profile's rows."""
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(n):
        row = rows[int(rng.integers(len(rows)))]
        st = int(rng.integers(0, len(row) - length))
        piece = row[st:st + length].copy()
        mut = rng.random(length) < 0.02
        piece[mut] = rng.integers(0, 4, int(mut.sum()))
        reads.append("".join("ACGT"[c] for c in piece))
    return reads


# (band lanes, D-chain bound, profile) of the row loop's special shapes:
# on the fixture's profile (K = 1,285), a band that is not a multiple of
# the warp's 32 lanes, a band past one lane a thread, and the chain cut
# below, at and past a warp's reach and unbounded; on the 6,000-column
# profile, the 4-lane launches (1,537-2,048 lanes) and the full width of
# 6,016 lanes (8 lanes a thread)
ROW_SHAPES = [(200, 1 << 30, "fixture"), (384, 1, "fixture"),
              (384, 2, "fixture"), (384, 32, "fixture"),
              (384, 33, "fixture"), (384, 1 << 30, "fixture"),
              (600, 33, "fixture"), (1408, 1 << 30, "fixture"),
              (1600, 1 << 30, "wide"), (2048, 33, "wide"),
              (6016, 1 << 30, "wide")]


@pytest.mark.parametrize("KP,dchain,profile", ROW_SHAPES)
def test_viterbi_kernel_row_shapes(request, KP, dchain, profile):
    """K1 bit-equal to its plain version at each shape, with a read of
    length 1, one that stops inside the batch and reads that fill every
    row; at the full width of the profile, K4 on the same reads."""
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch.hmm import NGCL, ViterbiAligner
    from hmmufotu_tpu_torch.hmm import cuda_viterbi as cv
    seed = KP + min(dchain, 99)
    if profile == "fixture":
        db = request.getfixturevalue("db")
        hmm, csfm = db.hmm, db.csfm
        reads = simulate_reads(db.ptu, 12, seed=seed, length=96)
    else:
        hmm, csfm, rows = request.getfixturevalue("wide_profile")
        reads = wide_reads(rows, 12, seed, 96)
    vp = pl.batch_find_seed_vpaths(hmm, csfm, reads, mode=NGCL)
    vp[5] = None                                    # one full-DP read
    al = ViterbiAligner(hmm, device="cuda")
    n_rows = 96
    codes, lengths, regions = al._encode(reads, vp, n_rows)
    lengths[0], lengths[2] = 1, 37
    K = hmm.K
    used = regions[:, :, 1] > 0
    jlo = np.where(used, np.maximum(regions[:, :, 0], 1), 1 << 30).min(1)
    jb = np.maximum(jlo - 1, 0).astype(np.int32)
    tc, em, scal = al.staged
    full = KP == tc.shape[1]
    if full:
        jb[:] = 0
    assert KP <= tc.shape[1]
    if profile == "wide":
        assert cv._lanes_per_thread(KP)[0] == (8 if full else 4)
    _, max_steps, _ = cv.launch_shape(K, n_rows, KP)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()
    meta = to(cv.make_meta(lengths, regions))
    args = (tc, em, scal, to(codes), meta, to(jb), n_rows, K, KP,
            max_steps, 5, dchain)
    got = cv.viterbi_traced_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, cv.viterbi_traced_plain(*args))
    if full:
        pargs = (tc, em, scal, to(codes), meta, n_rows, K)
        for a, b in zip(cv.viterbi_planes_cuda(*pargs),
                        cv.viterbi_planes_plain(*pargs)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_est_kernel_matches_plain(db):
    from hmmufotu_tpu_torch.phylo import cuda_place as cp
    U, V, Nl, site_ok, w0, wur0, wvr0 = lane_inputs(db.ptu)
    _, ms = model_inputs(db.ptu, 1)
    args = est_args(U, V, Nl, site_ok, wur0, wvr0, ms)
    args = tuple(x.cuda() for x in args[:-1]) + (args[-1],)
    n0 = cp.est_cuda.launches.n
    est_k, wnr_k = cp.est_cuda(*args)
    torch.cuda.synchronize()
    assert cp.est_cuda.launches.n == n0 + 1
    est_p, wnr_p = cp.est_plain(*args)
    assert torch.equal(wnr_k, wnr_p)
    torch.testing.assert_close(est_k, est_p, rtol=LL_RTOL, atol=LL_ATOL)


def synth_est_inputs(B, C, W, seed):
    """Random messages for K2 at any window: up/down log-probabilities,
    the leaf message of random reads (-inf off the base, log pi where
    the read has a gap) and a random per-read mask."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    U = np.log(rng.dirichlet(np.ones(4), (B, C, W))).transpose(0, 1, 3, 2)
    V = np.log(rng.dirichlet(np.ones(4), (B, C, W))).transpose(0, 1, 3, 2)
    base = rng.integers(-1, 4, (B, W))
    log_pi = np.log([0.3, 0.2, 0.2, 0.3])
    leaf = np.where(base[:, None, :] >= 0,
                    np.where(base[:, None, :] == np.arange(4)[:, None],
                             0.0, -np.inf), log_pi[:, None])
    Nl = np.broadcast_to(leaf[:, None], (B, C, 4, W))
    wur0 = rng.uniform(0.0, 0.2, (B, C))
    wvr0 = rng.uniform(0.0, 0.2, (B, C))
    return (U.astype(f32), V.astype(f32), Nl.astype(f32),
            random_site_mask(B, C, W, seed), wur0.astype(f32),
            wvr0.astype(f32))


# (B, C, W): the fixture's messages with C not a multiple of the block's
# warps; random messages at a window wide enough that a block holds fewer
# warps
@pytest.mark.parametrize("B,C,W,source", [(6, 7, 300, "fixture"),
                                          (5, 12, 2400, "random")])
def test_est_kernel_random_masks_nan_outside(db, B, C, W, source):
    """K2 with per-read inputs and random masks, U and V NaN or +-inf at
    every unmasked site: the kernel never reads them, so it agrees with
    the plain version on the clean inputs (wnr0 bit for bit)."""
    from hmmufotu_tpu_torch.phylo import cuda_place as cp
    if source == "fixture":
        U, V, Nl, _, w0, wur0, wvr0 = lane_inputs(db.ptu, B=B, C=C, W=W,
                                                  seed=9)
        site_ok = random_site_mask(B, C, W, seed=3)
    else:
        U, V, Nl, site_ok, wur0, wvr0 = synth_est_inputs(B, C, W, seed=5)
    _, ms = model_inputs(db.ptu, 1)
    args = est_args(U, V, Nl, site_ok, wur0, wvr0, ms)
    args = tuple(x.cuda() for x in args[:-1]) + (args[-1],)
    want = cp.est_plain(*args)
    off = (args[3] < 0.5).repeat_interleave(C, 0)
    junk = torch.tensor([np.nan, np.inf, -np.inf], device="cuda")[
        torch.arange(off.numel(), device="cuda").reshape(off.shape) % 3]
    Up, Vp = args[0].clone(), args[1].clone()
    for X in (Up, Vp):
        X[:, off] = junk[off]
    est_k, wnr_k = cp.est_cuda(Up, Vp, *args[2:])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(want[0]).all())
    assert torch.equal(wnr_k, want[1])
    torch.testing.assert_close(est_k, want[0], rtol=LL_RTOL, atol=LL_ATOL)


@pytest.mark.parametrize("n_rates", [1, 4])
def test_sep_kernel_matches_plain(db, n_rates):
    from hmmufotu_tpu_torch.phylo import cuda_place as cp
    U, V, Nl, site_ok, w0, wur0, _ = lane_inputs(db.ptu, seed=3)
    rng = np.random.default_rng(n_rates)
    wnr0 = rng.uniform(0.0, 0.2, w0.shape).astype(np.float32)
    live = rng.random(w0.shape) < 0.6
    _, ms = model_inputs(db.ptu, n_rates)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).reshape(-1)) \
        .cuda()
    args = tuple(x.cuda() for x in port_lanes(U, V, Nl, site_ok)) + (
        t(w0), t(wur0), t(wnr0), t(live), ms.cuda(), n_rates)
    n0 = cp.sep_cuda.launches.n
    got = cp.sep_cuda(*args)
    torch.cuda.synchronize()
    assert cp.sep_cuda.launches.n == n0 + 1
    want = cp.sep_plain(*args)
    lv = t(live)
    for q in range(3):
        torch.testing.assert_close(got[q][lv], want[q][lv], rtol=0,
                                   atol=BRANCH_ATOL)
    torch.testing.assert_close(got[3][lv], want[3][lv], rtol=LL_RTOL,
                               atol=LL_ATOL)
    assert all(bool((got[q][~lv] == 0).all()) for q in range(6))


@pytest.mark.parametrize("n_rates", [1, 4])
@pytest.mark.parametrize("which", ["no-lane-live", "every-lane-live"])
def test_sep_kernel_live_extremes(db, which, n_rates):
    """No live lane: zeros, and the launch still counts; every lane live:
    all of them within the tolerance."""
    from hmmufotu_tpu_torch.phylo import cuda_place as cp
    U, V, Nl, site_ok, w0, wur0, _ = lane_inputs(db.ptu, B=4, C=16, seed=5)
    wnr0 = np.random.default_rng(7).uniform(0.0, 0.2, w0.shape) \
        .astype(np.float32)
    live = np.full(w0.shape, which == "every-lane-live")
    _, ms = model_inputs(db.ptu, n_rates)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).reshape(-1)) \
        .cuda()
    args = tuple(x.cuda() for x in port_lanes(U, V, Nl, site_ok)) + (
        t(w0), t(wur0), t(wnr0), t(live), ms.cuda(), n_rates)
    n0 = cp.sep_cuda.launches.n
    got = cp.sep_cuda(*args)
    torch.cuda.synchronize()
    assert cp.sep_cuda.launches.n == n0 + 1
    if which == "no-lane-live":
        assert all(bool((g == 0).all()) for g in got)
        return
    want = cp.sep_plain(*args)
    for q in range(3):
        torch.testing.assert_close(got[q], want[q], rtol=0,
                                   atol=BRANCH_ATOL)
    torch.testing.assert_close(got[3], want[3], rtol=LL_RTOL, atol=LL_ATOL)
    assert bool((got[4] >= 1).all()) and bool((got[5] >= 2).all())


@pytest.mark.parametrize("unseeded", [(), (1, 5)])
def test_planes_kernel_matches_plain(db, unseeded):
    """K4: score, min_i, min_j and the packed planes bit-equal to the
    plain version on the same CUDA tensors; the host-traceback aligner
    gives the alignments of the default aligner."""
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch.hmm import NGCL, ViterbiAligner
    from hmmufotu_tpu_torch.hmm import cuda_viterbi as cv
    reads = simulate_reads(db.ptu, 16, seed=7 + len(unseeded))
    vp = pl.batch_find_seed_vpaths(db.hmm, db.csfm, reads, mode=NGCL)
    for r in unseeded:
        vp[r] = None
    host = ViterbiAligner(db.hmm, device="cuda", traceback_mode="host")
    n0 = cv.viterbi_planes_cuda.launches.n
    h = host.dispatch_batch(reads, vp)
    torch.cuda.synchronize()
    assert cv.viterbi_planes_cuda.launches.n == n0 + 1
    tc, em, scal = host.staged
    args = (tc, em, scal, torch.from_numpy(h[2]).cuda(),
            torch.from_numpy(cv.make_meta(h[3], h[4])).cuda(), h[1],
            db.hmm.K)
    for a, b in zip(cv.viterbi_planes_cuda(*args),
                    cv.viterbi_planes_plain(*args)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    want = ViterbiAligner(db.hmm, device="cuda").align_batch(reads, vp)
    for a, b in zip(host.finalize_batch(h), want):
        assert (a.align, a.cost) == (b.align, b.cost)


def test_fixed_point_kernel_matches_plain(cuda):
    from hmmufotu_tpu_torch.phylo import cuda_fixed_point as cf
    rng = np.random.default_rng(5)
    M, W = 1003, 512
    ok = rng.random((M, W)) < 0.5
    ok[7] = False                                  # n clamps to 1
    eA = np.where(ok, rng.uniform(0.01, 1.0, (M, W)), 0).astype(np.float32)
    eB = np.where(ok, rng.uniform(0.01, 1.0, (M, W)), 0).astype(np.float32)
    eA[11] = np.where(ok[11], 1e-30, 0)            # saturates at p -> 1
    n = np.maximum(ok.sum(1), 1).astype(np.float32)
    p0 = rng.uniform(0.01, 0.5, M).astype(np.float32)
    skip = rng.random(M) < 0.5
    skip[[7, 11]] = False
    args = tuple(torch.from_numpy(a).cuda() for a in (eA, eB, n, p0, skip))
    n0 = cf.fixed_point_cuda.launches.n
    got = cf.fixed_point(*args)
    torch.cuda.synchronize()
    assert cf.fixed_point_cuda.launches.n == n0 + 1
    want = cf.fixed_point_plain(*args)
    assert torch.equal(got[args[4]], args[3][args[4]])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("W", [128, 200, 512, 1000])
@pytest.mark.parametrize("case", ["all-skipped", "one-live", "saturating"])
def test_fixed_point_kernel_live_extremes(cuda, W, case):
    """K5 with no lane iterating (the output is p_init, untouched), with a
    single live lane among many, and with the saturating lane (eA = 1e-30)
    beside ordinary ones, at windows that fill one, two, four or eight
    sites of a thread.  Each lane's sites are random.  The kernel adds a
    lane's terms in the plain version's order (tree_sum), so p is bit for
    bit the plain version's."""
    from hmmufotu_tpu_torch.phylo import cuda_fixed_point as cf
    rng = np.random.default_rng(W)
    M = 777
    ok = rng.random((M, W)) < rng.uniform(0.2, 0.9, (M, 1))
    eA = np.where(ok, rng.uniform(0.01, 1.0, (M, W)), 0).astype(np.float32)
    eB = np.where(ok, rng.uniform(0.01, 1.0, (M, W)), 0).astype(np.float32)
    n = np.maximum(ok.sum(1), 1).astype(np.float32)
    p0 = rng.uniform(0.01, 0.5, M).astype(np.float32)
    skip = np.ones(M, bool)
    if case == "one-live":
        skip[400] = False
    elif case == "saturating":
        skip[::3] = False
        eA[3] = np.where(ok[3], 1e-30, 0)
    args = tuple(torch.from_numpy(a).cuda() for a in (eA, eB, n, p0, skip))
    n0 = cf.fixed_point_cuda.launches.n
    got = cf.fixed_point_cuda(*args)
    torch.cuda.synchronize()
    assert cf.fixed_point_cuda.launches.n == n0 + 1
    want = cf.fixed_point_plain(*args)
    assert torch.equal(got[args[4]], args[3][args[4]])
    assert torch.equal(got, want)
    if case == "saturating":
        assert float(got[3]) >= float(cf.SAT_P) > float(p0[3])


def test_torch_evaluate_engine_on_card(db):
    """The torch evaluate engine on the card against the numpy f64 engine
    on the fixture tree (GTR+dGamma4), with several site blocks: the same
    -inf pattern, max |delta| < 0.05, tree loglik within 1e-5 relative
    (the reference package's tolerances between its engines); two runs
    bit-equal."""
    import copy
    tree = copy.deepcopy(db.ptu)
    tree.evaluate()
    want = (tree.msg_up.copy(), tree.msg_down.copy())
    ll64 = tree.tree_loglik()
    runs = []
    for _ in range(2):
        tree.evaluate(dtype=np.float32, engine="torch",
                      budget_bytes=32 << 20, device="cuda")
        runs.append((tree.msg_up.copy(), tree.msg_down.copy()))
    for a, b, c in zip(runs[0], runs[1], want):
        assert np.array_equal(a, b)
        assert ((a == -np.inf) == (c == -np.inf)).all()
        f = np.isfinite(c)
        assert np.abs(a[f] - c[f]).max() < 0.05
    assert abs(tree.tree_loglik() - ll64) / abs(ll64) < 1e-5


@pytest.mark.parametrize("insert", [400, 600])
def test_pe_assign_on_card_matches_cpu(db_prefix, tmp_path, insert):
    """Paired-end assign on the card (K1 in GLOBAL mode on the mates, K2
    and K3 on the merged reads; 600 bp inserts give merged reads wider
    than the placer's window) against the port's CPU run: the same rows,
    with branch ratios and logliks within the placement tolerances."""
    from hmmufotu_tpu_torch.cli.assign import main
    from hmmufotu_tpu_torch.cli.sim import main as sim_main
    from hmmufotu_tpu_torch.hmm import cuda_viterbi as cv
    from hmmufotu_tpu_torch.phylo import cuda_place as cp
    r1, r2 = str(tmp_path / "pe_1.fa"), str(tmp_path / "pe_2.fa")
    assert sim_main([db_prefix, r1, "-m", r2, "-N", "24", "-S", "7",
                     "--mean-size", str(insert), "--sd-size", "20",
                     "-l", "150"]) == 0
    counters = (cv.viterbi_traced_cuda.launches, cp.est_cuda.launches,
                cp.sep_cuda.launches)
    n0 = [c.n for c in counters]
    rows = {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / f"{dev}.tsv"
        assert main([db_prefix, r1, r2, "-o", str(out), "-S", "0",
                     "-b", "32"], device=dev) == 0
        rows[dev] = [line.rstrip("\n").split("\t") for line in open(out)
                     if not line.startswith("#")]
        if dev == "cuda":
            assert all(c.n > k for c, k in zip(counters, n0))
    assert len(rows["cuda"]) == len(rows["cpu"]) > 1
    for g, c in zip(rows["cuda"][1:], rows["cpu"][1:]):
        assert g[:10] == c[:10]            # id .. alignment
        # branch and taxon
        assert (g[10], g[12], g[13]) == (c[10], c[12], c[13])
        assert float(g[11]) == pytest.approx(float(c[11]), abs=BRANCH_ATOL)
        assert float(g[15]) == pytest.approx(float(c[15]), rel=LL_RTOL,
                                             abs=LL_ATOL)


@pytest.mark.parametrize("K, budget", [(0, 12 << 20), (4, 48 << 20),
                                       (4, 256 << 20)])
def test_torch_evaluate_peak_within_budget_on_card(cuda, K, budget):
    """The device memory the torch evaluate engine allocates beyond what
    was held before it stays within budget_bytes (several site blocks a
    sweep at the two smaller budgets)."""
    from hmmufotu_tpu_torch.phylo import (DiscreteGammaModel, PTUnrooted,
                                          create_model)
    # the complete binary tree of scripts/scale_eval.py's synth_tree,
    # 2,000 leaves x 600 columns, JC69 (K = 0) or GTR + 4 Gamma rates
    rng = np.random.default_rng(11)
    n, L = 2000, 600
    N = 2 * n - 1
    t = PTUnrooted()
    t.cs_len, t.root = L, 0
    t.parent = np.arange(-1, N - 1) // 2
    t.parent[0] = -1
    t.brlen = rng.uniform(0.01, 0.1, N)
    t.brlen[0] = 0.0
    t.names, t.anno = [f"n{i}" for i in range(N)], [""] * N
    t.anno_dist, t.heights = np.zeros(N), np.zeros(N)
    t.msa_id = np.full(N, -1, dtype=np.int64)
    t.seqs = np.full((N, L), -128, dtype=np.int8)
    t.has_seq = np.zeros(N, dtype=bool)
    codes = rng.integers(0, 4, (n, L), dtype=np.int8)
    codes[rng.random((n, L)) < 0.1] = -2
    t.seqs[n - 1:] = codes
    t.has_seq[n - 1:] = True
    t.model = create_model("GTR" if K else "JC69")
    if K:
        t.dg = DiscreteGammaModel(0.6, K)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t.evaluate(dtype=np.float32, engine="torch", budget_bytes=budget,
               device="cuda")
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= budget


def record_launches(monkeypatch) -> list:
    """[(kernel, card of its tensors, current card, on that card's current
    stream)] of every kernel launch from here on."""
    from hmmufotu_tpu_torch import _cuda
    seen, real = [], _cuda.launch

    def launch(what, fn, on, *args):
        def recorded(*a):
            seen.append((what, on.device.index, torch.cuda.current_device(),
                         a[-1] == torch.cuda.current_stream(
                             on.device).cuda_stream))
            return fn(*a)
        return real(what, recorded, on, *args)

    monkeypatch.setattr(_cuda, "launch", launch)
    return seen


@pytest.mark.parametrize("msg_dtype", ["f32", "bf16"])
def test_resident_placer_on_card_matches_cpu(db, msg_dtype):
    """The window-resident placer (site_window, f32 or bf16 message
    storage) on the card against the same placer on the CPU, reads inside
    the window: the same c/p/a nodes but for one near tie, logliks within
    1e-4 relative + 0.5 (tests/test_pipeline.py), K2 and K3 launched."""
    from hmmufotu_tpu_torch.phylo import cuda_place as cp
    from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
    tree = db.ptu
    s0, Ws = 256, 768
    rng = np.random.default_rng(13)
    leaves = [u for u in range(tree.num_nodes)
              if tree.is_leaf(u) and tree.msa_id[u] >= 0]
    B = 32
    seqs = np.full((B, tree.cs_len), -2, np.int8)
    starts, ends = np.zeros(B, np.int32), np.zeros(B, np.int32)
    for r in range(B):
        codes = tree.seqs[int(rng.choice(leaves))]
        pos = np.nonzero(codes >= 0)[0]
        pos = pos[(pos >= s0) & (pos < s0 + Ws)]
        st = int(rng.integers(0, len(pos) - 200))
        w = pos[st:st + 200]
        seqs[r, w] = codes[w]
        starts[r], ends[r] = w[0], w[-1]
    dtype = torch.bfloat16 if msg_dtype == "bf16" else None
    out = {}
    n0 = (cp.est_cuda.launches.n, cp.sep_cuda.launches.n)
    for dev in ("cuda", "cpu"):
        placer = DevicePlacer(tree, window=256, max_nseed=24, device=dev,
                              msg_dtype=dtype, site_window=(s0, Ws))
        assert placer.dt.msg_up.shape[2] == Ws
        assert placer.dt.msg_up.dtype == (dtype or torch.float32)
        out[dev] = placer.place_batch(seqs, starts, ends,
                                      summary_only=True)["summary"]
    torch.cuda.synchronize()
    assert (cp.est_cuda.launches.n - n0[0],
            cp.sep_cuda.launches.n - n0[1]) == (1, 1)
    gpu, cpu = out["cuda"], out["cpu"]
    assert (gpu[:, 11] > 0).all() and (cpu[:, 11] > 0).all()
    np.testing.assert_allclose(gpu[:, 5], cpu[:, 5], rtol=LL_RTOL,
                               atol=LL_ATOL)
    differ = (gpu[:, :3] != cpu[:, :3]).any(1)
    assert differ.sum() <= 1, np.nonzero(differ)[0]


def test_sharded_placement_on_card(db, monkeypatch):
    """Four shards on the one card: sharded_place_batch and the
    tree-sharded placer with its host merge give the single-device
    summary (tests/test_sharding.py's gates; Q values as q_close says),
    K2 and K3 once a shard."""
    from hmmufotu_tpu_torch.parallel.sharding import Mesh
    check_sharded_placement(db, Mesh((torch.device("cuda", 0),) * 4),
                            monkeypatch)


def test_sharded_placement_across_cards(db, monkeypatch):
    """The same over every card of the host (make_mesh()), each shard's
    K2 and K3 launched on its own card and on that card's stream."""
    from hmmufotu_tpu_torch.parallel import make_mesh
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    check_sharded_placement(db, make_mesh(), monkeypatch)


def check_sharded_placement(db, mesh, monkeypatch):
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch.parallel import (sharded_place_batch,
                                             sharded_place_batch_tree)
    from hmmufotu_tpu_torch.phylo import cuda_place as cp
    from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
    tree = db.ptu
    rng = np.random.default_rng(5)
    leaves = [u for u in range(tree.num_nodes)
              if tree.is_leaf(u) and tree.msa_id[u] >= 0]
    B = 32
    seqs = np.full((B, tree.cs_len), -2, np.int8)
    starts, ends = np.zeros(B, np.int32), np.zeros(B, np.int32)
    for r in range(B):
        codes = tree.seqs[int(rng.choice(leaves))]
        pos = np.nonzero(codes >= 0)[0]
        st = int(rng.integers(0, max(1, len(pos) - 210)))
        w = pos[st:st + 200]
        seqs[r, w] = codes[w]
        starts[r], ends[r] = w[0], w[-1]
    placer = DevicePlacer(tree, window=256, max_nseed=24, device="cuda")
    single = placer.place_batch(seqs, starts, ends,
                                summary_only=True)["summary"]
    seen = record_launches(monkeypatch)
    n0 = (cp.est_cuda.launches.n, cp.sep_cuda.launches.n)
    sharded = sharded_place_batch(mesh, placer, seqs, starts, ends)
    assert (sharded[:, 0] == single[:, 0]).all()
    np.testing.assert_allclose(sharded[:, 5], single[:, 5], rtol=1e-5)
    union = sharded_place_batch_tree(mesh, placer, seqs, starts, ends)
    torch.cuda.synchronize()
    n = mesh.size
    assert (cp.est_cuda.launches.n - n0[0],
            cp.sep_cuda.launches.n - n0[1]) == (2 * n, 2 * n)
    cards = [d.index for d in mesh.devices]
    for k in ("est", "sep"):
        assert [s[1] for s in seen if s[0] == k] == cards * 2
    assert all(card == cur and on_stream for _, card, cur, on_stream in seen)
    merged = pl.merge_mp_candidates(tree, union, np.ones(B, bool), starts,
                                    ends, C=24)

    def q_close(a, b):
        # Q = -10 log10(1 - post) of an f32 posterior near 1: the host
        # merge and the card sum the weights in different orders, and one
        # ulp of 1 (1.2e-7) moves Q by ~0.05 at Q ~ 50 and from 69 to the
        # cap 250 where 1 - post rounds to 0; so Q values agree within
        # 0.05 or their error probabilities within 4 ulps of 1
        return abs(a - b) <= 0.05 \
            or abs(10 ** (-a / 10) - 10 ** (-b / 10)) <= 4 * 2 ** -23

    for r, p in enumerate(merged):
        assert (p.c_node, p.a_node) == (int(single[r, 0]),
                                        int(single[r, 2]))
        np.testing.assert_allclose(p.loglik, single[r, 5], rtol=1e-5)
        assert q_close(p.q_place, single[r, 6]), (r, p, single[r])
        assert q_close(p.q_taxon, single[r, 7]), (r, p, single[r])


@pytest.mark.parametrize("flag", ["--mesh", "--mesh-tree"])
def test_assign_mesh_across_cards(db_prefix, tmp_path, monkeypatch, flag):
    """assign with a mesh over every card of the host against the run
    that gives its rows in the reference package: for --mesh the run
    without a mesh; for --mesh-tree the same flag over as many CPU shards
    as there are cards, since the tree-sharded placer of both packages
    filters each shard's candidates against its own node block's best
    estimate and can pick another branch than one device
    (tests/test_torch_mesh_tree.py holds the CPU shards against the
    reference).  The same ids and alignments, and the same branch and
    taxon with logliks within the placement tolerances on every row but
    at most one near tie (a differing branch whose loglik agrees within
    them); K2 and K3 launched on every card, each on that card's
    stream."""
    from hmmufotu_tpu_torch import parallel
    from hmmufotu_tpu_torch.cli.assign import main
    from hmmufotu_tpu_torch.cli.sim import main as sim_main
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    reads = str(tmp_path / "reads.fa")
    assert sim_main([db_prefix, reads, "-N", "48", "-S", "7",
                     "-l", "150"]) == 0
    n_cards = torch.cuda.device_count()
    cpu_mesh = lambda *a, **kw: parallel.sharding.make_mesh(
        n_cards, device="cpu")
    runs = [("plain", [], "cuda"), ("mesh", [flag], "cuda")]
    if flag == "--mesh-tree":
        runs[0] = ("plain", [flag], "cpu")
    rows, seen = {}, []
    for tag, extra, device in runs:
        with monkeypatch.context() as m:
            if device == "cpu":
                m.setattr(parallel, "make_mesh", cpu_mesh)
            if tag == "mesh":
                seen = record_launches(m)
            out = tmp_path / f"{tag}.tsv"
            assert main([db_prefix, reads, "-o", str(out), "-b", "16"]
                        + extra, device=device) == 0
        rows[tag] = [line.rstrip("\n").split("\t") for line in open(out)
                     if not line.startswith("#")
                     and not line.startswith("id\t")]
    cards = set(range(torch.cuda.device_count()))
    for k in ("est", "sep"):
        assert {s[1] for s in seen if s[0] == k} == cards
    assert all(card == cur and on_stream for _, card, cur, on_stream in seen)
    got, want = rows["mesh"], rows["plain"]
    assert [r[0] for r in got] == [r[0] for r in want] and len(got) == 48
    near_ties = 0
    for g, w in zip(got, want):
        assert g[2:10] == w[2:10], g[0]
        if w[10] == "-1":
            assert g[10] == "-1", g[0]
            continue
        assert float(g[15]) == pytest.approx(float(w[15]), rel=LL_RTOL,
                                             abs=LL_ATOL), g[0]
        near_ties += (g[10], g[12], g[13]) != (w[10], w[12], w[13])
    assert near_ties <= 1
