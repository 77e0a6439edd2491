"""The port reads and builds the same databases as the reference package,
and convert.py carries the reference's staged device state across."""

import os

import numpy as np
import pytest
import torch

from test_torch_pipeline import one_torch_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _build_args(prefix):
    return [os.path.join(FIXTURES, "70_otus.fasta"),
            os.path.join(FIXTURES, "70_otus.tree"),
            "-a", os.path.join(FIXTURES, "70_otus_taxonomy.txt"),
            "-n", prefix, "-s", "GTR", "-V"]


@pytest.fixture(scope="module")
def prefixes(tmp_path_factory):
    """The 70_otus GTR+dGamma4 DB built by each package's builder."""
    from hmmufotu_tpu.cli.build import main as jax_build
    from hmmufotu_tpu_torch.cli.build import main as port_build
    d = tmp_path_factory.mktemp("db")
    ref, port = str(d / "ref"), str(d / "port")
    assert jax_build(_build_args(ref)) == 0
    assert port_build(_build_args(port)) == 0
    return ref, port


def assert_same_state(a, b, path="db", ignore=()):
    """Recursive equality of two objects' state: arrays bit for bit,
    containers element-wise, objects by class name and attributes
    (except those named in `ignore`)."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
    elif isinstance(a, dict):
        assert sorted(set(a) - set(ignore)) == sorted(set(b) - set(ignore)), \
            path
        for k in a:
            if k not in ignore:
                assert_same_state(a[k], b[k], f"{path}.{k}", ignore)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_state(x, y, f"{path}[{i}]", ignore)
    elif hasattr(a, "__dict__"):
        assert type(a).__name__ == type(b).__name__, path
        assert_same_state(vars(a), vars(b), path, ignore)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("part", ["msa", "csfm", "hmm", "ptu"])
def test_loader_reads_the_reference_db(prefixes, part):
    from hmmufotu_tpu.db import Database as RefDB
    from hmmufotu_tpu_torch.db import Database as PortDB
    ref, _ = prefixes
    want, got = getattr(RefDB.load(ref), part), getattr(PortDB.load(ref), part)
    if part != "ptu":
        assert_same_state(want, got, part)
        return
    # the port keeps the messages f32, as the file stores them (the
    # reference package widens them to f64, exactly); its host readers
    # widen the rows they read (msg_read_dtype)
    msgs = ("msg_up", "msg_down")
    assert_same_state(want, got, part, ignore=msgs + ("msg_read_dtype",))
    assert got.msg_read_dtype == np.float64
    for k in msgs:
        a, b = getattr(want, k), getattr(got, k)
        assert a.dtype == np.float64 and b.dtype == np.float32, k
        assert np.array_equal(a, np.float64(b), equal_nan=True), k


@pytest.mark.parametrize("part", ["msa", "csfm", "hmm", "ptu"])
def test_builder_matches_the_reference_builder(prefixes, part):
    from hmmufotu_tpu_torch.db import Database as PortDB
    ref, port = prefixes
    # `name` is the DB prefix given to -n, DATE the build time
    assert_same_state(getattr(PortDB.load(ref), part),
                      getattr(PortDB.load(port), part), part,
                      ignore=("name", "DATE"))


def test_save_round_trip(prefixes, tmp_path):
    from hmmufotu_tpu_torch.db import Database
    db = Database.load(prefixes[1])
    db.save(str(tmp_path / "again"))
    again = Database.load(str(tmp_path / "again"))
    for part in ("msa", "csfm", "hmm", "ptu"):
        assert_same_state(getattr(db, part), getattr(again, part), part)


def test_device_hmm_conversion(prefixes):
    from hmmufotu_tpu.db import Database as RefDB
    from hmmufotu_tpu.hmm.viterbi import DeviceHMM as RefDH
    from hmmufotu_tpu_torch.convert import (device_hmm_from_numpy,
                                            device_hmm_to_numpy)
    from hmmufotu_tpu_torch.db import Database as PortDB
    from hmmufotu_tpu_torch.hmm.viterbi import DeviceHMM
    ref = RefDB.load(prefixes[0]).hmm
    fields = {k: np.asarray(v)
              for k, v in RefDH.from_profile(ref)._asdict().items()}
    dh = device_hmm_from_numpy(fields, "cpu")
    own = DeviceHMM.from_profile(PortDB.load(prefixes[0]).hmm, "cpu")
    assert dh.K == ref.K
    back = device_hmm_to_numpy(dh)
    for k in DeviceHMM._fields:
        np.testing.assert_array_equal(back[k], fields[k])
        assert torch.equal(getattr(dh, k), getattr(own, k)), k


@pytest.mark.parametrize("msg_bf16", [False, True])
def test_device_tree_conversion(prefixes, msg_bf16):
    import jax.numpy as jnp
    from hmmufotu_tpu.db import Database as RefDB
    from hmmufotu_tpu.phylo.models import eig_tensors as ref_eig
    from hmmufotu_tpu.phylo.placement import DeviceTree as RefDT
    from hmmufotu_tpu_torch.convert import (device_tree_from_numpy,
                                            device_tree_to_numpy)
    from hmmufotu_tpu_torch.db import Database as PortDB
    from hmmufotu_tpu_torch.phylo.placement import DeviceTree
    tree = RefDB.load(prefixes[0]).ptu
    window = (200, 1024)
    staged = RefDT.from_tree(tree, msg_dtype=jnp.bfloat16 if msg_bf16
                             else None, site_window=window)
    fields = {k: (None if v is None else np.asarray(v))
              for k, v in staged._asdict().items()}
    dt, eig = device_tree_from_numpy(fields, ref_eig(tree.model), "cpu")
    own = DeviceTree.from_tree(
        PortDB.load(prefixes[0]).ptu, "cpu",
        msg_dtype=torch.bfloat16 if msg_bf16 else None, site_window=window)
    for k in DeviceTree._fields:
        a, b = getattr(dt, k), getattr(own, k)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype, k
            assert torch.equal(a, b), k
        else:
            assert a == b, k
    for a, b in zip(eig, ref_eig(tree.model)):
        np.testing.assert_array_equal(a.numpy(), np.float32(b))
    back = device_tree_to_numpy(dt)
    for k, v in fields.items():
        if v is None:
            assert back[k] is None
        else:
            np.testing.assert_array_equal(np.asarray(back[k], np.float64),
                                          np.asarray(v, np.float64))
