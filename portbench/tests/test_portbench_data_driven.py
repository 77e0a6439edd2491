"""A configuration, a traffic mix, a per-layer metric and a cell added as
files and BENCHMARK.json entries are picked up with no code edited."""

import hashlib
import json
import os

from conftest import make_checkout, run_cell


def code_digest(root):
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(os.path.join(root, "portbench"))):
        if ".cache" in d or "__pycache__" in d:
            continue
        for f in sorted(files):
            if f.endswith(".py") and os.path.basename(d) != "metrics":
                h.update(open(os.path.join(d, f), "rb").read())
    return h.hexdigest()


def test_new_files_make_a_new_cell(tmp_path):
    root = make_checkout(str(tmp_path))
    before = code_digest(root)
    pb = os.path.join(root, "portbench")
    cfg = json.load(open(os.path.join(pb, "configs", "tiny_dg4.json")))
    cfg.update(name="tiny_dg4_wide", columns=1500, db_seed=5)
    json.dump(cfg, open(os.path.join(pb, "configs", "tiny_dg4_wide.json"),
                        "w"))
    tr = json.load(open(os.path.join(pb, "traffic", "tiny_se.json")))
    tr.update(region=[600, 1300], read_len=200)
    json.dump(tr, open(os.path.join(pb, "traffic", "tiny_se200.json"), "w"))
    with open(os.path.join(pb, "metrics", "window_rows.py"), "w") as fh:
        fh.write('"""window_rows: rows the window completed."""\n\n'
                 'LAYER = "CLI rows and merge"\nUNIT = "rows"\n'
                 'SOURCE = "program_counter"\nMOVES = "reads_per_s"\n\n\n'
                 'def read(run):\n    return run["rows"]\n')
    # a metric that declares a span of its own, and a wrapper of its own
    with open(os.path.join(pb, "metrics", "seed_calls.py"), "w") as fh:
        fh.write('"""seed_calls: seed searches in the window."""\n\n'
                 'LAYER = "Seed search"\nUNIT = "calls"\n'
                 'SOURCE = "program_counter"\nMOVES = "reads_per_s"\n'
                 'SPANS = [("hmmufotu_tpu_torch.pipeline",\n'
                 '          "batch_find_seed_vpaths", "seed_calls")]\n\n\n'
                 'def install(patches, store):\n'
                 '    store["installed"] = True\n\n\n'
                 'def read(run):\n'
                 '    assert run["store"]["installed"]\n'
                 '    return run["calls"].get("seed_calls")\n')
    cell = "tiny_dg4_wide.se200"
    json.dump(json.load(open(os.path.join(pb, "checks",
                                          "tiny_dg4.se.json"))),
              open(os.path.join(pb, "checks", cell + ".json"), "w"))
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["workloads"].append({"name": cell, "config": "tiny_dg4_wide",
                               "traffic": "tiny_se200", "chips": 1,
                               "why": "added by a test"})
    bench["per_layer"].append({"name": "window_rows", "unit": "rows",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "CLI rows and merge",
                               "moves": "reads_per_s",
                               "workloads": [cell]})
    bench["per_layer"].append({"name": "seed_calls", "unit": "calls",
                               "better": "lower",
                               "source": "program_counter",
                               "layer": "Seed search",
                               "moves": "reads_per_s",
                               "workloads": [cell]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    rc, res, err = run_cell(root, cell, 3_000_000_031, trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["window_rows"]["value"] == res["attempted"]
    assert res["metrics"]["seed_calls"]["value"] > 0
    assert code_digest(root) == before
