"""Shared fixtures of the benchmark's own tests: a throw-away checkout
holding the benchmark, a link to the program, and tiny cells (a few
hundred leaves x 1,200 columns) beside the real ones."""

import json
import os
import shutil
import subprocess
import sys

import pytest

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PB)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


def make_checkout(dst: str) -> str:
    """A copy of BENCHMARK.json and portbench/ (no cache) under dst, with
    the program linked in, and the tiny cells tiny_dg4.se (single-end,
    four Gamma rates) and tiny_gtr.pe (pairs, one rate; its merge metric
    too), from the files of gg97_dg4.se250_v4 and of the paired cell
    left out of BENCHMARK.json (PERF.md §7)."""
    shutil.copytree(PB, os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    os.symlink(os.path.join(REPO, "hmmufotu_tpu_torch"),
               os.path.join(dst, "hmmufotu_tpu_torch"))
    pb = os.path.join(dst, "portbench")
    bench = json.load(open(os.path.join(dst, "BENCHMARK.json")))
    for src, name in (("gg97_dg4", "tiny_dg4"), ("gg97_gtr", "tiny_gtr")):
        c = json.load(open(os.path.join(pb, "configs", src + ".json")))
        c.update(name=name, leaves=300, columns=1200)
        json.dump(c, open(os.path.join(pb, "configs", name + ".json"), "w"))
    for src, name, upd in (
            ("se250_v4", "tiny_se", dict(region=[300, 900], batch=32,
                                         ceiling_rate=40, check_rows=6)),
            ("pe250_v34", "tiny_pe", dict(batch=16, ceiling_rate=20,
                                          check_rows=4))):
        t = json.load(open(os.path.join(pb, "traffic", src + ".json")))
        t.update(upd)
        json.dump(t, open(os.path.join(pb, "traffic", name + ".json"), "w"))
    limits = json.load(open(os.path.join(pb, "checks",
                                         "gg97_dg4.se250_v4.json")))
    for cell, cfg, tr in (("tiny_dg4.se", "tiny_dg4", "tiny_se"),
                          ("tiny_gtr.pe", "tiny_gtr", "tiny_pe")):
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": tr, "chips": 1,
                                   "why": "a test's tiny cell"})
        json.dump(limits, open(os.path.join(pb, "checks", cell + ".json"),
                               "w"))
    # the mates' merge, read where mates are merged
    bench["per_layer"].append({"name": "merge_s_per_kread", "unit": "s",
                               "better": "lower", "source": "program_span",
                               "layer": "CLI rows and merge",
                               "moves": "reads_per_s",
                               "workloads": ["tiny_gtr.pe"]})
    json.dump(bench, open(os.path.join(dst, "BENCHMARK.json"), "w"))
    return dst


def run_cell(checkout, cell, seed, seconds=40, trace=0, device="cpu",
             script="run.py", extra=()):
    """(returncode, result dict or None, stderr) of one run."""
    cmd = [sys.executable, os.path.join("portbench", script),
           "--workload", cell, "--seed", str(seed), "--seconds",
           str(seconds), "--device", device, *extra]
    if script == "run.py":
        cmd += ["--trace", str(trace)]
    # two threads a run and a 40 s window, so that runs of parallel test
    # workers each finish some of their window's batches on the CPU
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               MKL_NUM_THREADS="2", OPENBLAS_NUM_THREADS="2")
    p = subprocess.run(cmd, cwd=checkout, capture_output=True, text=True,
                       env=env, timeout=900)
    lines = p.stdout.strip().splitlines()
    res = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    return p.returncode, res, p.stderr


@pytest.fixture(scope="session")
def checkout(tmp_path_factory):
    return make_checkout(str(tmp_path_factory.mktemp("portbench")))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
