"""The PyTorch/CUDA port stands alone: it imports without jax and without
the reference package, and its entry points never fall back to the CPU."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "hmmufotu_tpu_torch")
# the port's gg_97-shape harnesses, and the generator of evolved inputs
# that chip_smoke.py and torch_scale_cli.py share
SCRIPTS = [os.path.join(REPO, "scripts", f"torch_scale_{n}.py")
           for n in ("eval", "assign", "e2e", "cli")]
GENERATOR = os.path.join(REPO, "scripts", "evolved_inputs.py")

IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
import hmmufotu_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
ref = sorted(m for m in sys.modules
             if m == "hmmufotu_tpu" or m.startswith("hmmufotu_tpu."))
assert not ref, ref
assert sys.modules["jax"] is None
for name in ("hmm.viterbi", "hmm.cuda_viterbi", "phylo.placement",
             "phylo.cuda_place", "phylo.cuda_fixed_point", "otu",
             "otu.table", "cli.sim", "cli.sum", "cli.jplace", "cli.subset",
             "cli.norm", "cli.merge", "parallel", "parallel.sharding",
             "parallel.distributed", "cli.anneal", "cli.inspect",
             "cli.train_dm", "cli.train_sm", "cli.train_hmm", "io",
             "io.reference_format"):
    assert "hmmufotu_tpu_torch." + name in names, name
print(len(names))
"""


def test_every_module_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 40


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield from SCRIPTS
    yield GENERATOR


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import(path):
    for line in open(path):
        s = line.strip()
        if not s.startswith(("import ", "from ")):
            continue
        mod = s.split()[1]
        assert mod.split(".")[0] != "jax", s
        assert mod != "hmmufotu_tpu" \
            and not mod.startswith("hmmufotu_tpu."), s


LOAD_SCRIPTS = r"""
import importlib.util, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["hmmufotu_tpu"] = None
for path in sys.argv[1:]:
    name = path.rsplit("/", 1)[1][:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    assert callable(getattr(mod, "main", None) or mod.synth_inputs), name
ref = sorted(m for m in sys.modules
             if m.startswith("hmmufotu_tpu.") or m.startswith("jax."))
assert not ref, ref
print(len(sys.argv) - 1)
"""


def test_scale_scripts_load_without_jax():
    """The four harnesses and the generator load with jax and the
    reference package blocked."""
    out = subprocess.run([sys.executable, "-c", LOAD_SCRIPTS] + SCRIPTS
                         + [GENERATOR], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "5"


@pytest.mark.parametrize("path", SCRIPTS,
                         ids=lambda p: os.path.basename(p))
def test_scale_scripts_refuse_cuda_without_a_card(monkeypatch, path):
    """Each harness runs on the card by default and raises without one."""
    import importlib.util
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.syspath_prepend(os.path.dirname(path))
    spec = importlib.util.spec_from_file_location(
        "card_check_" + os.path.basename(path)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        mod.main(["--leaves", "8", "--length", "600", "--reads", "4"]
                 if "eval" not in path else ["--leaves", "8"])


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    """device="cuda" is the default and raises without a GPU; the CPU
    runs only when asked for."""
    from hmmufotu_tpu_torch import _cuda
    from hmmufotu_tpu_torch.hmm import ProfileHMM, ViterbiAligner
    from hmmufotu_tpu_torch.mathx.dirichlet import HmmPrior
    from hmmufotu_tpu_torch.msa import MSA
    from hmmufotu_tpu_torch.phylo import load_model, parse_newick
    from hmmufotu_tpu_torch.phylo import PTUnrooted
    from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fx = os.path.join(REPO, "tests", "fixtures")
    msa = MSA.load_fasta(os.path.join(fx, "70_otus.fasta"))
    msa.prune()
    hmm = ProfileHMM.build(msa, 0.5,
                           HmmPrior.load(os.path.join(fx, "gg_97_otus.dm")))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ViterbiAligner(hmm)
    assert ViterbiAligner(hmm, device="cpu").device.type == "cpu"
    tree = PTUnrooted.from_newick(parse_newick(
        open(os.path.join(fx, "70_otus.tree")).read()))
    tree.load_msa(msa)
    tree.calc_node_height()
    tree.model = load_model(os.path.join(fx, "gg_97_otus_GTR.sm"))
    tree.evaluate()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        DevicePlacer(tree)
    assert DevicePlacer(tree, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        _cuda.resolve_device("mps")


def test_cli_refuses_cuda_without_a_card(monkeypatch, tmp_path):
    from hmmufotu_tpu_torch.cli.assign import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reads = tmp_path / "r.fasta"
    reads.write_text(">r\nACGT\n")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        main([str(tmp_path / "db"), str(reads)])


def test_chip_smoke_fails_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    # alone in a directory, without the package
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
