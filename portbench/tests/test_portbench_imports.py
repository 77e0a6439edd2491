"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either: module names compared
whole by their top-level part (hmmufotu_tpu_torch begins with
hmmufotu_tpu, and is not it)."""

import ast
import os
import subprocess
import sys

from conftest import PB, REPO

JAX = {"jax", "jaxlib", "flax", "hmmufotu_tpu"}
PROGRAM = "hmmufotu_tpu_torch"


def imported_tops(path: str) -> set[str]:
    tree = ast.parse(open(path).read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
    return tops


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(PB, sub)):
        if "tests" in d.split(os.sep) or ".cache" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        assert not imported_tops(path) & JAX, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert PROGRAM not in imported_tops(path), path
        assert not imported_tops(path) & JAX, path


def test_names_are_compared_whole():
    sys.path.insert(0, REPO)
    from portbench.run import forbidden_modules
    saved = dict(sys.modules)
    try:
        sys.modules["hmmufotu_tpu_torch_fake.x"] = object()
        sys.modules.pop("hmmufotu_tpu", None)
        assert "hmmufotu_tpu_torch_fake.x" not in forbidden_modules()
        sys.modules["hmmufotu_tpu.phylo"] = object()
        assert "hmmufotu_tpu.phylo" in forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_loading_the_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.harness, portbench.probes, portbench.dbcache\n"
            "import portbench.reference.judge, portbench.control\n"
            "import hmmufotu_tpu_torch.cli.assign, hmmufotu_tpu_torch.cli.build\n"
            "from portbench.run import forbidden_modules\n"
            "print(forbidden_modules())" % REPO)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]"
