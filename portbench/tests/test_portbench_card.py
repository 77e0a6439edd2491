"""On the card: a tiny cell through run.py, plain and traced, correct,
with the device's numbers read from the profiler."""

import pytest

from conftest import run_cell


@pytest.mark.cuda
def test_tiny_cell_on_the_card(checkout, card):
    rc, res, err = run_cell(checkout, "tiny_dg4.se", 3_000_000_043,
                            device="cuda", trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
    assert "device_idle_pct" in res["metrics"]
