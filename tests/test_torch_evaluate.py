"""The port's torch evaluate engine on the CPU, against its numpy f64
engine and the reference package's "jax" engine.

Tolerances are those of tests/test_scale_eval.py between the reference
package's two engines: the same -inf pattern (the observed leaf bases),
max |delta| < 0.05 on the finite entries, tree loglik within 1e-5
relative.  A tiny budget_bytes forces several site blocks.  The
reference's engine is run with a small EVAL_CHUNK, which only sets the
padded chunk its XLA-CPU kernels compile for."""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_pipeline import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
MSG_ATOL = 0.05
LL_RTOL = 1e-5
SMALL_BUDGET = 4 << 20
SMALL_CHUNK = 256


@pytest.fixture
def small_chunk(monkeypatch):
    import hmmufotu_tpu.phylo.tree as ref_tree
    monkeypatch.setattr(ref_tree, "EVAL_CHUNK", SMALL_CHUNK)


def synth_trees(K, n_leaves=300, length=473, seed=3):
    """(reference tree, port tree) with the same arrays: the complete
    binary tree of scripts/scale_eval.py, JC69 for K = 0, GTR with K
    Gamma rates otherwise."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from scale_eval import synth_tree
    from hmmufotu_tpu.phylo.dgamma import DiscreteGammaModel as RefDG
    from hmmufotu_tpu.phylo.models import create_model as ref_model
    from hmmufotu_tpu_torch.phylo import (DiscreteGammaModel, PTUnrooted,
                                          create_model)
    ref = synth_tree(n_leaves, length, seed=seed)
    t = PTUnrooted()
    for k in ("cs_len", "root", "parent", "brlen", "names", "anno",
              "anno_dist", "heights", "msa_id", "seqs", "has_seq"):
        setattr(t, k, getattr(ref, k))
    name = "GTR" if K else "JC69"
    ref.model, t.model = ref_model(name), create_model(name)
    if K:
        ref.dg, t.dg = RefDG(0.6, K), DiscreteGammaModel(0.6, K)
    return ref, t


def messages(tree):
    return tree.msg_up, tree.msg_down


def assert_messages_close(got, want):
    """got, want: (msg_up, msg_down)."""
    for a, b in zip(got, want):
        assert ((a == -np.inf) == (b == -np.inf)).all()
        f = np.isfinite(b)
        assert np.isfinite(a[f]).all()
        assert np.abs(a[f].astype(np.float64) - b[f]).max() < MSG_ATOL


@pytest.mark.parametrize("K", [0, 4])
def test_torch_engine_matches_numpy_and_jax(K, small_chunk):
    ref, t = synth_trees(K)
    t.evaluate()                                   # numpy, f64
    want = tuple(m.copy() for m in messages(t))
    ll64 = t.tree_loglik()
    ref.evaluate(dtype=np.float32, engine="jax", budget_bytes=SMALL_BUDGET)
    t.evaluate(dtype=np.float32, engine="torch", budget_bytes=SMALL_BUDGET,
               device="cpu")
    assert t.msg_up.dtype == np.float32
    assert_messages_close(messages(t), want)
    assert_messages_close(messages(t), messages(ref))
    assert abs(t.tree_loglik() - ll64) / abs(ll64) < LL_RTOL
    assert abs(t.tree_loglik() - ref.tree_loglik()) / abs(ll64) < LL_RTOL


@pytest.mark.parametrize("K", [0, 4])
def test_torch_engine_bit_equal_across_runs(K):
    _, t = synth_trees(K, n_leaves=200, length=300, seed=5)
    runs = []
    for _ in range(2):
        t.evaluate(dtype=np.float32, engine="torch",
                   budget_bytes=SMALL_BUDGET, device="cpu")
        runs.append(tuple(m.copy() for m in messages(t)))
    for a, b in zip(*runs):
        assert np.array_equal(a, b)


def test_torch_engine_site_window():
    """sites=(lo, hi) fills only those columns, with the full run's
    values there up to f32 rounding."""
    _, t = synth_trees(4, n_leaves=100, length=300, seed=7)
    t.evaluate()
    want = tuple(m.copy() for m in messages(t))
    t.evaluate(dtype=np.float32, engine="torch", sites=(100, 228),
               device="cpu")
    for a, b in zip(messages(t), want):
        assert not a[:, :, :100].any() and not a[:, :, 228:].any()
        w, v = a[:, :, 100:228], b[:, :, 100:228]
        assert ((w == -np.inf) == (v == -np.inf)).all()
        f = np.isfinite(v)
        assert np.abs(w[f] - v[f]).max() < MSG_ATOL


def test_unknown_engine_refused():
    _, t = synth_trees(0, n_leaves=8, length=16)
    with pytest.raises(ValueError, match="unknown evaluate engine"):
        t.evaluate(engine="jax")


def test_build_eval_engine_torch_matches_jax(tmp_path, small_chunk):
    """build --eval-engine torch (the port, on the CPU) against the
    reference's build --eval-engine jax, GTR+dGamma4: the same Gamma
    shape and the saved messages within the engines' tolerances."""
    from hmmufotu_tpu.cli.build import main as ref_build
    from hmmufotu_tpu_torch.cli.build import build_parser, main as build
    from hmmufotu_tpu_torch.phylo import PTUnrooted
    assert build_parser().parse_args(["a", "b"]).eval_engine == "numpy"
    base = [os.path.join(FIXTURES, "70_otus.fasta"),
            os.path.join(FIXTURES, "70_otus.tree"),
            "-a", os.path.join(FIXTURES, "70_otus_taxonomy.txt"),
            "-s", "GTR", "-V"]
    ref_p, p = str(tmp_path / "ref"), str(tmp_path / "port")
    assert ref_build(base + ["-n", ref_p, "--eval-engine", "jax"]) == 0
    assert build(base + ["-n", p, "--eval-engine", "torch"],
                 device="cpu") == 0
    ref, t = (PTUnrooted.load(x + ".ptu.npz") for x in (ref_p, p))
    assert t.dg.alpha == pytest.approx(ref.dg.alpha, rel=1e-6)
    assert_messages_close(messages(t), messages(ref))
    assert t.tree_loglik() == pytest.approx(ref.tree_loglik(), rel=LL_RTOL)


def test_torch_engine_refuses_cuda_without_a_card(monkeypatch):
    """device="cuda" is the default and raises without a GPU."""
    _, t = synth_trees(0, n_leaves=8, length=16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        t.evaluate(engine="torch")


def cpu_peak_bytes(fn) -> int:
    """The most bytes that CPU tensors held at once while fn ran: the
    profiler's allocations of each op and its frees, summed in time
    order."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        fn()
    steps = sorted(
        (e.time_range.start, e.cpu_memory_usage if e.name == "[memory]"
         else e.self_cpu_memory_usage) for e in prof.events())
    held = peak = 0
    for _, n in steps:
        held += n
        peak = max(peak, held)
    return peak


@pytest.mark.parametrize("K, budget", [(0, 12 << 20), (4, 48 << 20)])
def test_torch_engine_peak_within_budget(K, budget):
    """The blocks the engine sizes from budget_bytes keep the tensors it
    holds at once under the budget (here several blocks a sweep)."""
    _, t = synth_trees(K, n_leaves=2000, length=600, seed=11)
    peak = cpu_peak_bytes(lambda: t.evaluate(
        dtype=np.float32, engine="torch", budget_bytes=budget,
        device="cpu"))
    assert budget // 2 < peak <= budget
