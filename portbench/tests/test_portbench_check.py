"""The check of correct: its reference agrees with the program where it
should (the profile, the messages, each reported path's cost), its
control comes out not correct, and a run whose answers are altered
where they are produced comes out not correct."""

import json
import math
import os
import sys

import numpy as np
import pytest

from conftest import run_cell


def test_reference_profile_and_messages_match_the_program(checkout):
    sys.path.insert(0, checkout)
    from portbench import dbcache, gen
    from portbench.reference.hmm_ref import estimate_hmm
    from portbench.reference.messages import gamma_rates_sum1
    from hmmufotu_tpu_torch.hmm import ProfileHMM
    from hmmufotu_tpu_torch.mathx.dirichlet import HmmPrior
    from hmmufotu_tpu_torch.msa import MSA
    from hmmufotu_tpu_torch.phylo import (DiscreteGammaModel, PTUnrooted,
                                          load_model, parse_newick)
    d = os.path.join(checkout, "gen")
    g = gen.synth_inputs(d, 120, 900, 11)
    msa = MSA.load_fasta(os.path.join(d, gen.FASTA))
    msa.prune()
    hmm = ProfileHMM.build(msa, 0.5, HmmPrior.load(gen.DM_FILE))
    tab = estimate_hmm(g["codes"], gen.DM_FILE)
    assert int(tab["K"]) == hmm.K
    fin = np.isfinite(hmm.Tmat_cost)
    assert np.allclose(tab["Tmat_cost"][fin], hmm.Tmat_cost[fin],
                       rtol=1e-9, atol=1e-9)
    assert np.allclose(tab["E_M_cost"], hmm.E_M_cost, rtol=1e-9, atol=1e-9)
    text = open(os.path.join(d, gen.TREE)).read()
    tree = PTUnrooted.from_newick(parse_newick(text))
    tree.load_msa(msa)
    tree.fix_branch_length(1e-5)
    tree.model = load_model(gen.SM_FILE)
    tree.dg = DiscreteGammaModel(0.6, 4)
    tree.evaluate()
    cache = type("C", (), {"tree_text": os.path.join(d, gen.TREE),
                           "inputs": os.path.join(d, "g.npz")})()
    np.savez(cache.inputs, **g)
    rt = dbcache.reference_tree(cache, gamma_rates_sum1(0.6, 4))
    assert (rt.parent == tree.parent).all()
    up, down = rt.messages(100, 500, "cpu")
    up, down = up.numpy(), down.numpy()
    for mine, theirs in ((up, tree.msg_up[:, :, 100:500]),
                         (down, tree.msg_down[:, :, 100:500])):
        fin = np.isfinite(theirs)
        assert (np.isfinite(mine) == fin).all()
        assert np.allclose(mine[fin], theirs[fin], rtol=1e-9, atol=1e-8)


def test_path_score_is_the_programs_cost(checkout):
    sys.path.insert(0, checkout)
    from portbench import dbcache, harness
    from portbench.reference.hmm_ref import path_score, ref_hmm
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch.hmm import NGCL, ProfileHMM, ViterbiAligner
    from hmmufotu_tpu_torch.index import CSFMIndex
    cfg = json.load(open(os.path.join(checkout, "portbench", "configs",
                                      "tiny_dg4.json")))
    cache = dbcache.DbCache(cfg)
    if not cache.complete():
        assert run_cell(checkout, "tiny_dg4.se", 5, seconds=5)[0] == 0
    hmm = ProfileHMM.from_hmmer_file(cache.hmm)
    hmm.set_sequence_mode(NGCL)
    hmm.wing_retract()
    traffic = json.load(open(os.path.join(checkout, "portbench", "traffic",
                                          "tiny_se.json")))
    fwd, _ = harness.make_traffic(traffic, 13, 120,
                                  np.load(cache.inputs)["codes"])
    alns = pl.align_reads(ViterbiAligner(hmm, device="cpu"),
                          CSFMIndex.load(cache.csfm),
                          [r.seq for r in fwd], mode=NGCL)
    ref = ref_hmm(dict(np.load(cache.ref_hmm)), "ngcl")
    for r, a in zip(fwd, alns):
        row = dict(alignment=a.align, seq_start=a.seq_start,
                   seq_end=a.seq_end, hmm_start=a.hmm_start,
                   hmm_end=a.hmm_end)
        assert abs(path_score(ref, r.seq, row) - a.cost) < 2e-3
        bad = dict(row, alignment=a.align.replace("A", "C", 1))
        sc = path_score(ref, r.seq, bad)
        assert sc is None or abs(sc - a.cost) > 0.05


def test_the_control_is_not_correct(checkout):
    rc, res, err = run_cell(checkout, "tiny_dg4.se", 3_000_000_037,
                            script="control.py")
    assert rc == 0, err[-3000:]
    assert res["mode"] == "control"
    assert res["correct"] is False
    bad = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert {"aln_score_err", "place_gap_ulps"} <= set(bad), res["checks"]


@pytest.mark.parametrize("mode,number", [("seed_shift", "aln_off_pct"),
                                         ("second_best", "place_gap_ulps")])
def test_a_planted_fault_is_not_correct(checkout, mode, number):
    """control.py's faults: the seed hits moved on in the program (a
    valid path around the wrong columns), and the reference's
    second-best placement put in the program's place."""
    rc, res, err = run_cell(checkout, "tiny_dg4.se", 3_000_000_043,
                            script="control.py", extra=("--mode", mode))
    assert rc == 0, err[-3000:]
    assert res["mode"] == mode
    assert res["correct"] is False
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]


def test_q_ulps():
    from portbench.reference.judge import F32_ONE_ULP, q_ulps
    from portbench.reference.ref_phylo import MAX_Q
    L = [-1000.0, -1002.0, -1010.0]
    S = math.exp(-2.0) + math.exp(-10.0)      # the others' weights
    e = S / (1 + S)                           # candidate 0's error
    q = -10 * math.log10(e)
    assert q_ulps(q, L, 0, 0.25) < 1e-3
    # the log-odds 1 nat off: 2 ulps of 0.25 on each side
    e1 = e * math.e / (1 - e + e * math.e)
    assert abs(q_ulps(-10 * math.log10(e1), L, 0, 0.25) - 2.0) < 1e-3
    # an error probability below f32's reach reads MAX_Q on both sides
    assert q_ulps(MAX_Q, [-1000.0, -1100.0], 0, 0.25) == 0.0
    assert q_ulps(MAX_Q, [-1000.0, -1001.0], 0, 0.25) > 10
    assert F32_ONE_ULP == 2.0 ** -24


FAULTS = {
    # the placement's loglik altered where the CLI writes the row
    "loglik": ("place_tsv", "lambda tree, place: orig(tree, place) if place "
               "is None else orig(tree, type(place)(**{**place.__dict__, "
               "'loglik': place.loglik * (1 + 1e-3)}))"),
    # the alignment's cost altered where the CLI writes the row
    "cost": ("aln_tsv", "lambda aln: orig(type(aln)(**{**aln.__dict__, "
             "'cost': aln.cost + 1.0}))"),
    # the taxon of another node written
    "taxon": ("place_tsv", "lambda tree, place: orig(tree, place) if place "
              "is None else orig(tree, type(place)(**{**place.__dict__, "
              "'a_node': place.p_node if place.a_node == place.c_node "
              "else place.c_node}))"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_an_altered_answer_is_not_correct(checkout, fault):
    """The run with one of the CLI's row writers replaced by one that
    alters each answer it writes."""
    name, body = FAULTS[fault]
    site = os.path.join(checkout, "fault_" + fault)
    os.makedirs(site, exist_ok=True)
    with open(os.path.join(site, "sitecustomize.py"), "w") as fh:
        fh.write(f"import sys\nsys.path.insert(0, {checkout!r})\n"
                 "import hmmufotu_tpu_torch.cli.assign as m\n"
                 f"orig = m.{name}\n"
                 f"m.{name} = {body}\n")
    env_path = os.environ.get("PYTHONPATH", "")
    os.environ["PYTHONPATH"] = site + (os.pathsep + env_path
                                       if env_path else "")
    try:
        rc, res, err = run_cell(checkout, "tiny_dg4.se", 3_000_000_041)
    finally:
        os.environ["PYTHONPATH"] = env_path
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res["checks"]
