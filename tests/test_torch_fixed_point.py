"""The placer's other branches: the tensor-op convolutions
(_dot_scaled, _dot_scaled_vec, _conv_mix), the single-branch fixed point
in both of its forms (the tensor-op loop, and K5 through its plain
version fixed_point_plain, the CPU path of phylo/cuda_fixed_point), and
DevicePlacer with each (sep_kernel, fp_kernel, est_kernel) setting,
against the reference package with the same flags on the same
numpy-seeded inputs.  The reference's _fp_kernel and SEP kernel run in
interpret mode.

Tolerances.  The convolutions and the fixed point evaluate the same f32
formulas with sums in another order (XLA's reduce and einsum against
torch's): 1e-5 relative, plus 1e-5 absolute on the log-domain
convolutions, whose values pass through exp and log.  That holds for the
same P(t) on both sides, so the convolution tests hand both the same
matrices, computed in f64 numpy.  P(t) itself is held to 3e-7 absolute
(an ulp of 1, the size of its spectral terms): its small off-diagonal
entries come from cancelling those terms, so their relative error, and
with it the absolute error of a log-domain convolution, reaches 1e-4
between any two f32 evaluations, the reference's own paths included.
A fixed-point lane that stops within BRANCH_EPS = 1e-5 of its limit may
stop one step apart on the two sides, so branch lengths agree to 2e-5
absolute beside the 1e-5 relative.  Placers: the tolerances of tests/test_pipeline.py
(branch lengths 2e-3, logliks 1e-4 relative + 0.5)."""

import copy

import numpy as np
import pytest
import torch

from test_torch_place import (BRANCH_ATOL, LL_ATOL, LL_RTOL,  # noqa: F401
                              lane_inputs, leaf_reads, model_inputs, trees)
from test_torch_pipeline import one_torch_thread  # noqa: F401

RTOL = 1e-5


def _pr_fns(tree):
    """(P(t) for jax arrays, P(t) for torch tensors), both returning the
    same f32 matrices: the spectral form evaluated in f64 numpy."""
    import jax.numpy as jnp
    from hmmufotu_tpu_torch.phylo.models import eig_tensors
    Um, U_1, lam = (np.asarray(x, np.float64)
                    for x in eig_tensors(tree.model))

    def pmat(v):
        e = np.exp(lam * np.asarray(v, np.float64)[..., None])
        return np.maximum((Um * e[..., None, :]) @ U_1, 0.0) \
            .astype(np.float32)

    return (lambda v: jnp.asarray(pmat(v)),
            lambda v: torch.from_numpy(pmat(v.numpy())))


def test_pr_fn_matches_reference(trees):
    import jax.numpy as jnp
    from hmmufotu_tpu.phylo.placement import make_pr_fn as ref_make
    from hmmufotu_tpu_torch.phylo.placement import make_pr_fn
    _, tree = trees
    (Um, U_1, lam, _, _), _ = model_inputs(tree, 1)
    v = np.random.default_rng(2).uniform(0, 0.5, (3, 8)).astype(np.float32)
    v[0, 0] = 0.0
    want = np.asarray(ref_make(tuple(jnp.asarray(x) for x in (Um, U_1, lam)),
                               "eig", jnp.float32)(jnp.asarray(v)))
    got = make_pr_fn(tuple(torch.from_numpy(x) for x in (Um, U_1, lam)))(
        torch.from_numpy(v)).numpy()
    assert got.shape == want.shape == (3, 8, 4, 4)
    assert (got >= 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-7)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_dot_scaled_matches_reference(trees):
    import jax.numpy as jnp
    from hmmufotu_tpu.phylo import placement as rp
    from hmmufotu_tpu_torch.phylo import placement as pp
    ref_tree, tree = trees
    U, V, Nl, _, w0, wur0, _ = lane_inputs(ref_tree)
    ref_pmat, pmat = _pr_fns(tree)
    log_pi = np.log(np.asarray(tree.model.pi)).astype(np.float32)
    for msg in (U, Nl):            # Nl holds -inf entries and all-pi sites
        want = np.asarray(rp._dot_scaled(ref_pmat(jnp.asarray(wur0)),
                                         jnp.asarray(msg)))
        got = pp._dot_scaled(pmat(torch.from_numpy(wur0)),
                             torch.from_numpy(np.ascontiguousarray(msg)))
        assert got.shape == want.shape == msg.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-5)
        want = np.asarray(rp._dot_scaled_vec(jnp.asarray(log_pi),
                                             jnp.asarray(msg + V)))
        got = pp._dot_scaled_vec(torch.from_numpy(log_pi),
                                 torch.from_numpy(msg + V))
        assert got.shape == want.shape == msg.shape[:2] + msg.shape[3:]
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("n_rates", [1, 4])
def test_conv_mix_matches_reference(trees, n_rates):
    import jax.numpy as jnp
    from hmmufotu_tpu.phylo import placement as rp
    from hmmufotu_tpu_torch.phylo import placement as pp
    ref_tree, tree = trees
    U, V, Nl, _, w0, wur0, wvr0 = lane_inputs(ref_tree, seed=5)
    wnr = np.random.default_rng(0).uniform(0, 0.2, w0.shape) \
        .astype(np.float32)
    ref_pmat, pmat = _pr_fns(tree)
    rates = (np.asarray(tree.dg.rates, np.float32) if n_rates > 1
             else np.ones(1, np.float32))
    j, t = jnp.asarray, lambda a: torch.from_numpy(np.ascontiguousarray(a))
    want = np.asarray(rp._conv_mix(
        ref_pmat, j(rates), [(j(U), j(wur0)), (j(V), j(wvr0)),
                           (j(Nl), j(wnr))]))
    got = pp._conv_mix(pmat, t(rates), [(t(U), t(wur0)), (t(V), t(wvr0)),
                                      (t(Nl), t(wnr))])
    assert got.shape == want.shape == U.shape
    assert np.isfinite(want).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-5)


def _fp_inputs(tree):
    """[2, 6] lanes of fixed-point inputs: lane (0, 1) skipped, lane
    (0, 2) with an empty site mask (n clamps to 1), lane (1, 0) driven
    to saturation by a near message that contradicts the far one at
    every site, the rest ordinary."""
    U, V, Nl, site_ok, w0, wur0, _ = lane_inputs(tree, B=2, C=6, seed=7)
    R = (U + V).astype(np.float32)
    X = np.ascontiguousarray(Nl)
    site_ok = np.ascontiguousarray(site_ok)
    site_ok[0, 2] = False
    # saturating lane: near message certain of base 0, far of base 1
    R[1, 0] = np.where(np.arange(4)[:, None] == 0, 0.0, -80.0)
    X[1, 0] = np.where(np.arange(4)[:, None] == 1, 0.0, -80.0)
    skip = np.zeros(w0.shape, bool)
    skip[0, 1] = True
    w_init = np.random.default_rng(1).uniform(0.01, 0.3, w0.shape) \
        .astype(np.float32)
    max_len = np.ones_like(w_init)
    return R, X, w_init, site_ok, max_len, skip


@pytest.mark.parametrize("kernel", [False, True])
def test_fixed_point_branch_matches_reference(trees, kernel):
    import jax.numpy as jnp
    from hmmufotu_tpu.phylo import placement as rp
    from hmmufotu_tpu_torch.phylo import placement as pp
    ref_tree, tree = trees
    R, X, w_init, site_ok, max_len, skip = _fp_inputs(ref_tree)
    log_pi = np.log(np.asarray(tree.model.pi)).astype(np.float32)
    j, t = jnp.asarray, torch.from_numpy
    want = np.asarray(rp._fixed_point_branch(
        j(log_pi), j(R), j(X), j(w_init), j(site_ok), j(max_len),
        skip=j(skip), use_pallas=kernel))
    got = pp._fixed_point_branch(
        t(log_pi), t(R), t(X), t(w_init), t(site_ok), t(max_len),
        skip=t(skip), use_kernel=kernel).numpy()
    assert got.shape == want.shape == w_init.shape
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=2e-5)
    # the skipped lane returns its start (through 1 - exp(-w) and back)
    assert got[0, 1] == pytest.approx(w_init[0, 1], rel=1e-5)
    # the saturating lane runs to the cap
    assert got[1, 0] == max_len[1, 0] == want[1, 0]
    # no skip given: every lane iterates
    want = np.asarray(rp._fixed_point_branch(
        j(log_pi), j(R), j(X), j(w_init), j(site_ok), j(max_len),
        use_pallas=kernel))
    got = pp._fixed_point_branch(
        t(log_pi), t(R), t(X), t(w_init), t(site_ok), t(max_len),
        use_kernel=kernel).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=2e-5)


def test_fixed_point_plain_matches_fp_kernel_interpret(trees):
    """K5's plain version against the reference Pallas kernel itself on
    the same pre-scaled factors: p within 1e-6 absolute beside 1e-5
    relative (one more or fewer step inside BRANCH_EPS of the limit)."""
    import jax.numpy as jnp
    from hmmufotu_tpu.phylo.placement import _fixed_point_pallas
    from hmmufotu_tpu_torch.phylo.cuda_fixed_point import (fixed_point,
                                                           fixed_point_plain)
    rng = np.random.default_rng(3)
    M, W = 150, 96                 # not multiples of the TPU block sizes
    ok = rng.random((M, W)) < 0.7
    ok[5] = False
    eA = np.where(ok, rng.uniform(0.01, 1.0, (M, W)), 0).astype(np.float32)
    eB = np.where(ok, rng.uniform(0.01, 1.0, (M, W)), 0).astype(np.float32)
    n = np.maximum(ok.sum(1), 1).astype(np.float32)
    p0 = rng.uniform(0.01, 0.5, M).astype(np.float32)
    skip = rng.random(M) < 0.3
    want = np.asarray(_fixed_point_pallas(*map(jnp.asarray,
                                               (eA, eB, n, p0, skip))))
    args = tuple(map(torch.from_numpy, (eA, eB, n, p0, skip)))
    got = fixed_point_plain(*args).numpy()
    assert got.shape == want.shape == (M,)
    np.testing.assert_array_equal(got[skip], p0[skip])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    assert (np.abs(got - p0)[~skip] > 1e-3).any()
    # on CPU tensors the wrapper is the plain version
    np.testing.assert_array_equal(fixed_point(*args).numpy(), got)


@pytest.mark.parametrize("W", [1, 96, 128, 300, 1000])
def test_tree_sum_is_the_halving_tree(W):
    """K5's order of summation: zeros up to 128 * 2^k columns, then
    halves added pairwise, each level rounded to f32 (as the kernel's
    thread slots, shared-memory stage and butterfly add them)."""
    from hmmufotu_tpu_torch.phylo.cuda_fixed_point import tree_sum
    x = np.random.default_rng(W).uniform(0, 1, (5, W)).astype(np.float32)

    def halves(v):
        if len(v) == 1:
            return v[0]
        h = len(v) // 2
        return halves(v[:h] + v[h:])        # f32 adds, element by element

    Wt = 128
    while Wt < W:
        Wt *= 2
    want = [halves(np.pad(r, (0, Wt - W))) for r in x]
    got = tree_sum(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.array(want, np.float32))
    np.testing.assert_allclose(got, x.sum(1), rtol=1e-5)


@pytest.mark.parametrize("W", [128, 512, 1000])
@pytest.mark.parametrize("live", ["none", "one"])
def test_fixed_point_plain_live_extremes_match_fp_kernel_interpret(live, W):
    """K5's plain version against the reference Pallas kernel with no lane
    iterating, and with one lane iterating among many, at windows up to
    and past the 512 sites the CUDA kernel holds in registers.  Each
    lane's informative sites are one run, as on the placer's path."""
    import jax.numpy as jnp
    from hmmufotu_tpu.phylo.placement import _fixed_point_pallas
    from hmmufotu_tpu_torch.phylo.cuda_fixed_point import fixed_point_plain
    rng = np.random.default_rng(W)
    M = 40
    lo = rng.integers(0, W // 2, M)
    hi = lo + rng.integers(W // 4, W // 2, M)
    ok = (np.arange(W) >= lo[:, None]) & (np.arange(W) < hi[:, None])
    eA = np.where(ok, rng.uniform(0.01, 1.0, (M, W)), 0).astype(np.float32)
    eB = np.where(ok, rng.uniform(0.01, 1.0, (M, W)), 0).astype(np.float32)
    n = np.maximum(ok.sum(1), 1).astype(np.float32)
    p0 = rng.uniform(0.01, 0.5, M).astype(np.float32)
    skip = np.ones(M, bool)
    if live == "one":
        skip[17] = False
    want = np.asarray(_fixed_point_pallas(*map(jnp.asarray,
                                               (eA, eB, n, p0, skip))))
    got = fixed_point_plain(*map(torch.from_numpy,
                                 (eA, eB, n, p0, skip))).numpy()
    np.testing.assert_array_equal(got[skip], p0[skip])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    if live == "one":
        assert abs(got[17] - p0[17]) > 1e-3


@pytest.fixture(scope="module")
def trees_by_rates(trees):
    """{4: the dGamma4 trees, 1: shallow copies with the Gamma model
    dropped}, each (reference tree, port tree)."""
    one = tuple(copy.copy(t) for t in trees)
    for t in one:
        t.dg = None
    return {4: trees, 1: one}


FLAGS = [(False, False, True), (False, True, True), (True, True, False)]


@pytest.mark.parametrize("n_rates", [1, 4])
@pytest.mark.parametrize("sep,fp,est", FLAGS)
def test_placer_branch_matches_reference(trees_by_rates, n_rates, sep, fp,
                                         est):
    """The loop-of-tensor-ops optimize with and without K5, and K3 fed by
    the tensor-op estimate, against the reference DevicePlacer with the
    same flags (tests/test_pipeline.py:208-219)."""
    from hmmufotu_tpu.phylo.placement import DevicePlacer as RefPlacer
    from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
    ref_tree, tree = trees_by_rates[n_rates]
    seqs, starts, ends = leaf_reads(ref_tree, 4, seed=3)
    ref_placer = RefPlacer(ref_tree, window=256, max_nseed=8,
                           sep_pallas=sep, fp_pallas=fp, est_kernel=est)
    placer = DevicePlacer(tree, window=256, max_nseed=8, device="cpu",
                          sep_kernel=sep, fp_kernel=fp, est_kernel=est)
    assert placer.n_rates == ref_placer.n_rates == n_rates
    want = ref_placer.place_batch(seqs, starts, ends)
    got = placer.place_batch(seqs, starts, ends)
    np.testing.assert_array_equal(got["cand"], np.asarray(want["cand"]))
    live = np.asarray(want["live"])
    np.testing.assert_array_equal(got["live"], live)
    assert live.any() and (~live).any()
    for k in ("ratio", "wnr"):
        np.testing.assert_allclose(got[k][live], np.asarray(want[k])[live],
                                   atol=BRANCH_ATOL)
    np.testing.assert_allclose(got["loglik"][live],
                               np.asarray(want["loglik"])[live],
                               rtol=LL_RTOL, atol=LL_ATOL)
    np.testing.assert_array_equal(got["summary"][:, :3],
                                  np.asarray(want["summary"])[:, :3])


@pytest.mark.parametrize("sep,fp,est", [(True, True, True)] + FLAGS)
def test_placer_with_fewer_nodes_than_max_nseed(trees, sep, fp, est):
    """A tree of N < max_nseed nodes gives every read its N nodes as
    candidates: the same placement as max_nseed = N, on every branch."""
    from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
    _, tree = trees
    N = tree.num_nodes
    seqs, starts, ends = leaf_reads(tree, 2, seed=5)
    got, want = (DevicePlacer(tree, window=256, max_nseed=c, device="cpu",
                              sep_kernel=sep, fp_kernel=fp, est_kernel=est)
                 .place_batch(seqs, starts, ends) for c in (N + 20, N))
    assert got["cand"].shape == (2, N)
    for k in ("cand", "live", "wnr", "loglik", "summary"):
        np.testing.assert_array_equal(got[k], want[k])


def test_placer_branches_agree_with_default(trees):
    """Every branch of the port places the reads on the nodes the default
    fused path picks, with the same tolerances."""
    from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
    _, tree = trees
    seqs, starts, ends = leaf_reads(tree, 4, seed=9)
    base = DevicePlacer(tree, window=256, max_nseed=8, device="cpu") \
        .place_batch(seqs, starts, ends)
    live = base["live"]
    for sep, fp, est in FLAGS:
        out = DevicePlacer(tree, window=256, max_nseed=8, device="cpu",
                           sep_kernel=sep, fp_kernel=fp, est_kernel=est
                           ).place_batch(seqs, starts, ends)
        np.testing.assert_array_equal(out["cand"], base["cand"])
        np.testing.assert_array_equal(out["live"], live)
        np.testing.assert_allclose(out["wnr"][live], base["wnr"][live],
                                   atol=BRANCH_ATOL)
        np.testing.assert_allclose(out["loglik"][live], base["loglik"][live],
                                   rtol=LL_RTOL, atol=LL_ATOL)
        np.testing.assert_array_equal(out["summary"][:, :3],
                                      base["summary"][:, :3])
