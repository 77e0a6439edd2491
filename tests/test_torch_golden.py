"""The oracle's goldens (BASELINE configs #1-#2's correctness target)
through the port's build, sim, assign and jplace CLIs on the CPU.

tests/golden_assign_categories.tsv (40 single-end reads, GTR, sim -S 0)
and tests/golden_jplace_pe.tsv (20 pairs, GTR+dGamma4, sim -S 5) were
written by the independent f64 oracle (tests/oracle/); the checks are
tests/test_pipeline.py TestGoldenCategories', applied by
scripts/torch_run_parity.py golden_assign and golden_jplace: each read's
taxon equal to the oracle's and its branch in the oracle's tie set; each
pair's jplace edge id exact, likelihood within max(0.05, 1e-5 |ll|),
lengths within 1e-4.  tests/test_torch_cuda.py runs the same on the
card."""

import os
import sys

import pytest

from test_torch_pipeline import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import torch_run_parity as trp  # noqa: E402


def test_assignments_match_golden(tmp_path):
    res = trp.golden_assign(str(tmp_path), device="cpu")
    assert res["failures"] == []
    assert res["n"] == 40 and res["rows"] == 40


def test_pe_jplace_matches_golden(tmp_path):
    res = trp.golden_jplace(str(tmp_path), device="cpu")
    assert res["failures"] == []
    assert res["n"] == 20 and res["rows"] == 20
