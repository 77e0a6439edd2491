"""Each cell's path through run.py on the CPU at a tiny size: the
contract's last line, the split of set-up, the window's rows judged."""

import json
import os

import pytest

from conftest import REPO, run_cell

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def test_single_end_cell_is_correct_and_prints_the_line(checkout):
    rc, res, err = run_cell(checkout, "tiny_dg4.se", 3_000_000_019)
    assert rc == 0, err[-3000:]
    assert KEYS <= set(res)
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"reads_per_s", "setup_s", "host_rss_gb"}
    assert res["device"]["platform"] == "cpu"
    split = res["setup_split"]
    assert {"db_load_s", "evaluate_upload_s", "read_pool_s"} <= set(split)
    # set-up leaves out the DB's build, which the split records apart
    parts = sum(v for k, v in split.items() if k != "db_build_s")
    assert split["other_s"] >= 0
    assert abs(parts - res["metrics"]["setup_s"]["value"]) < 1e-6
    # the compared numbers end stderr, each beside its limit
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(ln.startswith("check ") and " limit " in ln for ln in tail)


def test_paired_cell_runs_the_batch_loop(checkout):
    rc, res, err = run_cell(checkout, "tiny_gtr.pe", 3_000_000_023,
                            trace=1)
    assert rc == 0, err[-3000:]
    assert KEYS <= set(res)
    assert res["attempted"] > 0
    assert res["judged"]["rows_judged"] > 0
    # the mates' merge is read in the pairs' cell only
    assert "merge_s_per_kread" in res["metrics"]
    assert "seed_s_per_kread" in res["metrics"]


def test_traced_run_reports_the_per_layer_metrics(checkout):
    rc, res, err = run_cell(checkout, "tiny_dg4.se", 3_000_000_029,
                            trace=1)
    assert rc == 0, err[-3000:]
    bench = json.load(open(os.path.join(checkout, "BENCHMARK.json")))
    names = {m["name"] for m in bench["per_layer"]}
    assert set(res["metrics"]) <= names
    # host spans are read on the CPU; the device's numbers are not
    assert {"db_load_s", "seed_s_per_kread", "strings_s_per_kread",
            "place_host_s_per_kread", "rows_s_per_kread"} <= set(
        res["metrics"])
    assert "device_idle_pct" not in res["metrics"]
    assert "merge_s_per_kread" not in res["metrics"]


def test_no_card_means_no_result(checkout):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, res, _ = run_cell(checkout, "tiny_dg4.se", 1, device="cuda")
    assert rc == 2 and res is None


def test_a_bare_checkout_gives_no_result(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ (no program)
    exits non-zero and prints no result."""
    import shutil
    import subprocess
    import sys
    shutil.copytree(os.path.join(REPO, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "gg97_dg4.se250_v4", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip()
