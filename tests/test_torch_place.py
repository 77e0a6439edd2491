"""K2 (estimate) and K3 (joint 3-branch optimization): the port's plain
PyTorch versions (the CPU path of phylo/cuda_place.py) against the
reference Pallas kernels in interpret mode, the seed p-dist product, and
the port's batched placement against the reference DevicePlacer on its
fused-kernel branch (sep_pallas=True).

Tolerances are those of tests/test_pipeline.py: branch lengths within
2e-3 absolute, logliks within 1e-4 relative + 0.5 absolute.  The two
sides evaluate the same f32 formulas, but sums over sites are taken in
another order (XLA's reduce vs torch's), and each fixed point iterates
to 1e-5 on its own rounding."""

import os

import numpy as np
import pytest
import torch

from test_torch_pipeline import one_torch_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
BRANCH_ATOL = 2e-3
LL_RTOL, LL_ATOL = 1e-4, 0.5


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The 70_otus GTR+dGamma4 DB built by the reference builder, loaded
    by each package: (reference tree, port tree)."""
    from hmmufotu_tpu.cli.build import main as build_main
    from hmmufotu_tpu.db import Database as RefDB
    from hmmufotu_tpu_torch.db import Database as PortDB
    prefix = str(tmp_path_factory.mktemp("db") / "70_otus")
    assert build_main([os.path.join(FIXTURES, "70_otus.fasta"),
                       os.path.join(FIXTURES, "70_otus.tree"),
                       "-a", os.path.join(FIXTURES, "70_otus_taxonomy.txt"),
                       "-n", prefix, "-s", "GTR", "-V"]) == 0
    return RefDB.load(prefix).ptu, PortDB.load(prefix).ptu


def leaf_reads(tree, B, seed, length=200):
    """[B, csLen] digital reads (2% substitutions) cut from leaves."""
    rng = np.random.default_rng(seed)
    leaves = [u for u in range(tree.num_nodes)
              if tree.is_leaf(u) and tree.msa_id[u] >= 0]
    seqs = np.full((B, tree.cs_len), -2, dtype=np.int8)
    starts = np.zeros(B, np.int32)
    ends = np.zeros(B, np.int32)
    for r in range(B):
        codes = tree.seqs[int(rng.choice(leaves))]
        pos = np.nonzero(codes >= 0)[0]
        st = int(rng.integers(0, max(1, len(pos) - length - 10)))
        w = pos[st:st + length]
        piece = codes[w].copy()
        mut = rng.random(len(piece)) < 0.02
        piece[mut] = rng.integers(0, 4, int(mut.sum()))
        seqs[r, w] = piece
        starts[r], ends[r] = w[0], w[-1]
    return seqs, starts, ends


def lane_inputs(tree, B=3, C=8, W=256, seed=2):
    """Candidate-lane inputs of both kernels: [B, C, 4, W] up/down/leaf
    message windows at random branches, the [B, C, W] site mask and the
    initial branch splits, all numpy f32."""
    rng = np.random.default_rng(seed)
    seqs, starts, ends = leaf_reads(tree, B, seed)
    nodes = np.array([u for u in range(tree.num_nodes)
                      if tree.parent[u] >= 0])
    cand = rng.choice(nodes, (B, C))
    sc = np.minimum(starts, tree.cs_len - W)
    cols = sc[:, None] + np.arange(W)                        # [B, W]
    U = tree.msg_up[cand[:, :, None, None], np.arange(4)[:, None],
                    cols[:, None, None, :]].astype(np.float32)
    V = tree.msg_down[cand[:, :, None, None], np.arange(4)[:, None],
                      cols[:, None, None, :]].astype(np.float32)
    win = seqs[np.arange(B)[:, None], cols]                  # [B, W]
    leaf = np.where(win[:, None, :] >= 0,
                    np.where(win[:, None, :] == np.arange(4)[None, :, None],
                             0.0, -np.inf),
                    np.log(np.asarray(tree.model.pi))[None, :, None])
    Nl = np.broadcast_to(leaf[:, None], (B, C, 4, W)).astype(np.float32)
    site_ok = np.broadcast_to(((cols >= starts[:, None])
                               & (cols <= ends[:, None]))[:, None],
                              (B, C, W))
    w0 = np.asarray(tree.brlen, np.float32)[cand]
    wur0 = (w0 * rng.uniform(0.1, 0.9, (B, C))).astype(np.float32)
    return U, V, Nl, site_ok, w0, wur0, (w0 - wur0).astype(np.float32)


def port_lanes(U, V, Nl, site_ok):
    from hmmufotu_tpu_torch.phylo.cuda_place import pad_msgs
    t = torch.from_numpy
    return pad_msgs(t(np.ascontiguousarray(U)), t(np.ascontiguousarray(V)),
                    t(np.ascontiguousarray(Nl)),
                    t(np.ascontiguousarray(site_ok)))


def port_reads(Nl, site_ok):
    """K2's per-read leaf plane and mask from the [B, C, ...] lane grids
    (the same for every candidate of a read)."""
    from hmmufotu_tpu_torch.phylo.cuda_place import pad_reads
    t = lambda a: torch.from_numpy(np.array(a))      # a writable copy
    return pad_reads(t(Nl[:, 0]), t(site_ok[:, 0]))


def est_args(U, V, Nl, site_ok, wur0, wvr0, ms):
    """est_plain's / est_cuda's arguments from [B, C, ...] numpy grids."""
    Up, Vp, _, _ = port_lanes(U, V, Nl, site_ok)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).reshape(-1))
    return (Up, Vp, *port_reads(Nl, site_ok), t(wur0), t(wvr0), ms,
            U.shape[1])


def random_site_mask(B, C, W, seed):
    """A random [B, C, W] mask, the same for every candidate of a read,
    with one read masked everywhere but one site."""
    rng = np.random.default_rng(seed)
    m = rng.random((B, W)) < rng.uniform(0.2, 0.8, (B, 1))
    m[-1] = False
    m[-1, W // 3] = True
    return np.broadcast_to(m[:, None], (B, C, W))


def model_inputs(tree, n_rates):
    from hmmufotu_tpu_torch.phylo.cuda_place import model_scalars
    from hmmufotu_tpu_torch.phylo.models import eig_tensors
    Um, U_1, lam = (np.asarray(x, np.float32)
                    for x in eig_tensors(tree.model))
    log_pi = np.log(np.asarray(tree.model.pi)).astype(np.float32)
    rates = (np.asarray(tree.dg.rates, np.float32) if n_rates > 1
             else np.ones(1, np.float32))
    ms = model_scalars(Um, U_1, lam, torch.from_numpy(log_pi), rates,
                       n_rates)
    return (Um, U_1, lam, log_pi, rates), ms


def _est_ref(U, V, Nl, site_ok, wur0, wvr0, tree):
    import jax.numpy as jnp
    from hmmufotu_tpu.phylo.pallas_place import est_pallas
    (Um, U_1, lam, log_pi, _), _ = model_inputs(tree, 1)
    j = jnp.asarray
    est_r, wnr_r = est_pallas(j(U), j(V), j(Nl), j(site_ok), j(wur0),
                              j(wvr0), j(Um), j(U_1), j(lam), j(log_pi),
                              interpret=True)
    return np.asarray(est_r).reshape(-1), np.asarray(wnr_r).reshape(-1)


def test_est_plain_matches_pallas_interpret(trees):
    from hmmufotu_tpu_torch.phylo.cuda_place import est_plain
    ref_tree, tree = trees
    U, V, Nl, site_ok, w0, wur0, wvr0 = lane_inputs(ref_tree)
    _, ms = model_inputs(tree, 1)
    est_r, wnr_r = _est_ref(U, V, Nl, site_ok, wur0, wvr0, tree)
    est_p, wnr_p = est_plain(*est_args(U, V, Nl, site_ok, wur0, wvr0, ms))
    assert np.isfinite(est_r).all()
    # wnr0 is a count of argmax mismatches over the same sites: exact
    np.testing.assert_array_equal(wnr_p.numpy(), wnr_r)
    np.testing.assert_allclose(est_p.numpy(), est_r, rtol=LL_RTOL,
                               atol=LL_ATOL)


@pytest.mark.parametrize("masks", ["contiguous", "random"])
def test_est_plain_per_read_matches_pallas_interpret(trees, masks):
    """Per-read leaf message and mask on a [B, C] grid (C > 1, W not a
    multiple of 128), each read's mask one run of sites or random sites,
    against the reference kernel given the same per-lane grids."""
    from hmmufotu_tpu_torch.phylo.cuda_place import est_plain
    ref_tree, tree = trees
    B, C, W = 4, 5, 200
    U, V, Nl, site_ok, w0, wur0, wvr0 = lane_inputs(ref_tree, B=B, C=C,
                                                    W=W, seed=11)
    if masks == "random":
        site_ok = random_site_mask(B, C, W, seed=4)
    _, ms = model_inputs(tree, 1)
    est_r, wnr_r = _est_ref(U, V, Nl, site_ok, wur0, wvr0, tree)
    est_p, wnr_p = est_plain(*est_args(U, V, Nl, site_ok, wur0, wvr0, ms))
    assert est_p.shape == wnr_p.shape == (B * C,)
    assert np.isfinite(est_r).all() and (wnr_r > 0).any()
    np.testing.assert_array_equal(wnr_p.numpy(), wnr_r)
    np.testing.assert_allclose(est_p.numpy(), est_r, rtol=LL_RTOL,
                               atol=LL_ATOL)


def test_est_plain_ignores_messages_at_unmasked_sites(trees):
    """NaN and +-inf in U and V wherever the read's mask is off leave the
    estimate and wnr0 bit for bit as they were: what lets the kernel skip
    those sites."""
    from hmmufotu_tpu_torch.phylo.cuda_place import est_plain
    _, tree = trees
    B, C, W = 3, 4, 256
    U, V, Nl, _, w0, wur0, wvr0 = lane_inputs(tree, B=B, C=C, W=W, seed=6)
    site_ok = random_site_mask(B, C, W, seed=8)
    _, ms = model_inputs(tree, 1)
    args = est_args(U, V, Nl, site_ok, wur0, wvr0, ms)
    want = est_plain(*args)
    off = (args[3] < 0.5).repeat_interleave(C, 0)          # [M, Wp]
    junk = torch.tensor([np.nan, np.inf, -np.inf])[
        torch.arange(off.numel()).reshape(off.shape) % 3]
    Up, Vp = args[0].clone(), args[1].clone()
    for X in (Up, Vp):
        X[:, off] = junk[off]
    got = est_plain(Up, Vp, *args[2:])
    assert torch.isfinite(want[0]).all()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_est_refuses_lanes_not_b_times_c(trees):
    """Both wrappers refuse lane planes that are not B * C lanes of the
    per-read inputs, before any kernel or tensor op runs."""
    from hmmufotu_tpu_torch.phylo.cuda_place import est, est_cuda
    _, tree = trees
    U, V, Nl, site_ok, w0, wur0, wvr0 = lane_inputs(tree, B=3, C=4,
                                                    W=128, seed=2)
    _, ms = model_inputs(tree, 1)
    args = est_args(U, V, Nl, site_ok, wur0, wvr0, ms)
    for fn in (est, est_cuda):
        with pytest.raises(ValueError, match="B \\* C"):
            fn(*args[:-1], 5)
    # the leaf plane per lane, as K3 takes it, is refused
    with pytest.raises(ValueError, match="per read"):
        est(args[0], args[1], args[0], *args[3:])


@pytest.mark.parametrize("n_rates", [1, 4])
def test_sep_plain_matches_pallas_interpret(trees, n_rates):
    import jax.numpy as jnp
    from hmmufotu_tpu.phylo.pallas_place import sep_optimize_pallas
    from hmmufotu_tpu_torch.phylo.cuda_place import sep_plain
    ref_tree, tree = trees
    U, V, Nl, site_ok, w0, wur0, _ = lane_inputs(ref_tree, B=2, C=4,
                                                  seed=3)
    B, C = w0.shape
    rng = np.random.default_rng(n_rates)
    wnr0 = rng.uniform(0.0, 0.2, (B, C)).astype(np.float32)
    live = rng.random((B, C)) < 0.6
    live[0, 0] = True
    (Um, U_1, lam, log_pi, rates), ms = model_inputs(tree, n_rates)
    j = jnp.asarray
    ref = sep_optimize_pallas(j(U), j(V), j(Nl), j(site_ok), j(w0),
                              j(wur0), j(wnr0), j(live), j(Um), j(U_1),
                              j(lam), j(log_pi), j(rates), n_rates,
                              interpret=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).reshape(-1))
    got = sep_plain(*port_lanes(U, V, Nl, site_ok), t(w0), t(wur0),
                    t(wnr0), t(live), ms, n_rates)
    lv = live.reshape(-1)
    for q in range(3):          # wur, wvr, wnr
        np.testing.assert_allclose(got[q].numpy()[lv],
                                   np.asarray(ref[q]).reshape(-1)[lv],
                                   atol=BRANCH_ATOL)
    ll_ref = np.asarray(ref[3]).reshape(-1)[lv]
    assert np.isfinite(ll_ref).all()
    np.testing.assert_allclose(got[3].numpy()[lv], ll_ref, rtol=LL_RTOL,
                               atol=LL_ATOL)
    # dead lanes are left at zero, trip counts only on live lanes
    assert all((got[q].numpy()[~lv] == 0).all() for q in range(6))
    assert (got[4].numpy()[lv] >= 1).all()


@pytest.mark.parametrize("n_rates", [1, 4])
@pytest.mark.parametrize("which", ["no-lane-live", "every-lane-live"])
def test_sep_plain_live_extremes(trees, which, n_rates):
    """A batch with no live lane is all zeros without touching a message;
    one with every lane live agrees with the reference on all of them."""
    import jax.numpy as jnp
    from hmmufotu_tpu.phylo.pallas_place import sep_optimize_pallas
    from hmmufotu_tpu_torch.phylo.cuda_place import sep_plain
    ref_tree, tree = trees
    U, V, Nl, site_ok, w0, wur0, _ = lane_inputs(ref_tree, B=2, C=3,
                                                  seed=5)
    wnr0 = np.random.default_rng(7).uniform(0.0, 0.2, w0.shape) \
        .astype(np.float32)
    live = np.full(w0.shape, which == "every-lane-live")
    (Um, U_1, lam, log_pi, rates), ms = model_inputs(tree, n_rates)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).reshape(-1))
    got = sep_plain(*port_lanes(U, V, Nl, site_ok), t(w0), t(wur0),
                    t(wnr0), t(live), ms, n_rates)
    assert all(g.shape == (w0.size,) for g in got)
    if which == "no-lane-live":
        assert all((g.numpy() == 0).all() for g in got)
        return
    j = jnp.asarray
    ref = sep_optimize_pallas(j(U), j(V), j(Nl), j(site_ok), j(w0),
                              j(wur0), j(wnr0), j(live), j(Um), j(U_1),
                              j(lam), j(log_pi), j(rates), n_rates,
                              interpret=True)
    for q in range(3):
        np.testing.assert_allclose(got[q].numpy(),
                                   np.asarray(ref[q]).reshape(-1),
                                   atol=BRANCH_ATOL)
    np.testing.assert_allclose(got[3].numpy(),
                               np.asarray(ref[3]).reshape(-1),
                               rtol=LL_RTOL, atol=LL_ATOL)
    assert (got[4].numpy() >= 1).all() and (got[5].numpy() >= 2).all()


def test_live_lane_list_is_the_live_lanes_in_order():
    """The device-side list K3 works from: live lane indices in order,
    then the count and a zeroed work counter."""
    from hmmufotu_tpu_torch.phylo.cuda_place import live_lane_list
    rng = np.random.default_rng(3)
    for live in (rng.random((4, 50)) < 0.1, np.zeros(7, bool),
                 np.ones((2, 3), bool)):
        lanes, ctrl = live_lane_list(torch.from_numpy(live))
        want = np.nonzero(live.reshape(-1))[0]
        assert lanes.dtype == torch.int32 and ctrl.tolist() == [len(want),
                                                                0]
        np.testing.assert_array_equal(lanes.numpy()[:len(want)], want)


def test_seed_pdist_counts_are_exact():
    """The bf16 one-hot planes are upcast to f32 before the product, so
    mismatch counts well above 256 (where a bf16 result would round)
    stay exact: the p-dist equals the f32 quotient of integer counts."""
    from hmmufotu_tpu_torch.phylo.placement import seed_pdist_bf16
    rng = np.random.default_rng(17)
    B, N, Ws = 16, 300, 2048
    seqs_w = rng.integers(-2, 4, (B, Ws)).astype(np.int8)
    nseqs = rng.integers(-2, 4, (N, Ws)).astype(np.int8)
    starts = rng.integers(0, Ws // 4, B)
    ends = starts + rng.integers(100, 3 * Ws // 4, B)
    site = np.arange(Ws)[None, :]
    q_valid = (seqs_w >= 0) & (site >= starts[:, None]) \
        & (site <= ends[:, None])
    n1h = torch.from_numpy(
        (nseqs[:, :, None] == np.arange(4, dtype=np.int8))
        .reshape(N, Ws * 4)).to(torch.bfloat16)
    nv = torch.from_numpy(nseqs >= 0).to(torch.bfloat16)
    dist = seed_pdist_bf16(torch.from_numpy(seqs_w),
                           torch.from_numpy(q_valid), n1h, nv).numpy()
    nvalid = nseqs >= 0
    big = 0
    for b in range(B):
        for n in range(N):
            both = q_valid[b] & nvalid[n]
            nb = int(both.sum())
            if nb == 0:
                assert np.isnan(dist[b, n])
                continue
            mism = int((seqs_w[b][both] != nseqs[n][both]).sum())
            big += mism > 256
            assert dist[b, n] == np.float32(mism) / np.float32(nb)
    assert big > 0


@pytest.mark.parametrize("ref_rank,ml_only,height_prior", [
    (False, False, False), (True, False, False), (False, True, False),
    (False, False, True)])
def test_finish_placement_matches_reference(trees, ref_rank, ml_only,
                                            height_prior):
    """Q values and the best-placement summary from identical candidate
    arrays: read 0 has 40 live candidates, so the reference-binary rank
    (ref_rank) picks past the 16-element insertion-sort threshold; read
    3 has none."""
    import jax.numpy as jnp
    from hmmufotu_tpu.phylo.placement import DeviceTree as RefDT
    from hmmufotu_tpu.phylo.placement import _finish_placement as ref_fin
    from hmmufotu_tpu_torch.phylo.placement import (DeviceTree,
                                                    _finish_placement)
    ref_tree, tree = trees
    rng = np.random.default_rng(21)
    B, C = 4, 40
    nodes = np.array([u for u in range(tree.num_nodes)
                      if tree.parent[u] >= 0])
    cand = rng.choice(nodes, (B, C))
    live = np.zeros((B, C), bool)
    live[0] = True
    live[1, :20] = True
    live[2, [3, 7, 11]] = True
    f32 = lambda a: np.asarray(a, np.float32)
    c_dist = f32(rng.uniform(0, 0.1, (B, C)))
    w0 = f32(np.asarray(tree.brlen)[cand])
    wur = f32(w0 * rng.uniform(0, 1, (B, C)))
    wvr = f32(w0 - wur)
    wnr = f32(rng.uniform(0, 0.3, (B, C)))
    loglik = f32(np.where(live, -900 + 3 * rng.standard_normal((B, C)),
                          -np.inf))
    est = f32(loglik + rng.standard_normal((B, C)))
    args = (cand, c_dist, live, w0, wur, wvr, wnr, loglik, est)
    want = ref_fin(RefDT.from_tree(ref_tree), *map(jnp.asarray, args),
                   np.inf, height_prior, ml_only, ref_rank)
    got = _finish_placement(DeviceTree.from_tree(tree, "cpu"),
                            *map(torch.from_numpy, args), np.inf,
                            height_prior, ml_only, ref_rank)
    s_ref, s = np.asarray(want["summary"]), got["summary"].numpy()
    np.testing.assert_array_equal(s[:, [0, 1, 2, 11]],
                                  s_ref[:, [0, 1, 2, 11]])
    np.testing.assert_allclose(s, s_ref, rtol=1e-5, atol=1e-5)
