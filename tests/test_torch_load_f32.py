"""A DB file's messages stay f32 in the port's PTUnrooted.load (as the file
stores them), and every host reader of them computes the f64 numbers the
reference package computes on its loaded tree, which widens them whole.

On the 70_otus DBs (GTR+dGamma4 and GTR, written by the reference package's
build CLI): each reader bit for bit on the two packages' loaded trees; the
load's peak memory (no f64 copy); and the reference package's load of a
file the port saved (zlib level 1) back to the port's state."""

import os
import tracemalloc

import numpy as np
import pytest

from test_torch_pipeline import one_torch_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
MODELS = {"gtr_dgamma4": ["-V"], "gtr": []}
READERS = ["estimate_seq", "place_seq", "node_loglik", "tree_loglik",
           "infer_seq", "estimate_num_mutations", "sim",
           "reference_format"]
# the load's peak over the bytes of the arrays it returns: the f32
# messages and the rest, and read buffers; an f64 copy of the messages
# would make it at least 3
LOAD_PEAK_RATIO = 1.2


@pytest.fixture(scope="module")
def prefixes(tmp_path_factory):
    """model -> the DB prefix the reference package's build CLI wrote."""
    from hmmufotu_tpu.cli.build import main as ref_build
    d = tmp_path_factory.mktemp("db")
    out = {}
    for name, flags in MODELS.items():
        out[name] = str(d / name)
        assert ref_build([os.path.join(FIXTURES, "70_otus.fasta"),
                          os.path.join(FIXTURES, "70_otus.tree"), "-a",
                          os.path.join(FIXTURES, "70_otus_taxonomy.txt"),
                          "-n", out[name], "-s", "GTR"] + flags) == 0
    return out


def loaded(prefix):
    """(the reference package's tree, the port's tree) of one DB file."""
    from hmmufotu_tpu.phylo import PTUnrooted as RefTree
    from hmmufotu_tpu_torch.phylo import PTUnrooted
    return (RefTree.load(prefix + ".ptu.npz"),
            PTUnrooted.load(prefix + ".ptu.npz"))


def reads(tree, n=6, seed=3):
    """(node, start, end, seq): leaf windows of 150 columns with 5% of
    their bases changed, as encoded read sequences."""
    rng = np.random.default_rng(seed)
    L = tree.cs_len
    leaves = [u for u in range(tree.num_nodes)
              if tree.is_leaf(u) and tree.has_seq[u]]
    out = []
    for u in rng.choice(leaves, n, replace=False):
        start = int(rng.integers(0, L - 150))
        end = start + 149
        seq = np.full(L, -1, np.int8)
        seq[start:end + 1] = tree.seqs[u][start:end + 1]
        flip = (rng.random(L) < 0.05) & (seq >= 0)
        seq[flip] = (seq[flip] + 1) % 4
        out.append((int(u), start, end, seq))
    return out


def same(a, b):
    """Bit-equal numbers: arrays of the same dtype and shape, or floats."""
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    else:
        assert a == b and type(a) is type(b)


def placement_fields(p):
    return (p.c_node, p.p_node, p.a_node, p.wuv, p.ratio, p.wnr,
            p.loglik, p.height)


@pytest.mark.parametrize("reader", READERS)
@pytest.mark.parametrize("model", list(MODELS))
def test_readers_are_bit_equal_on_f32_messages(prefixes, tmp_path, model,
                                               reader):
    from hmmufotu_tpu.phylo import PTLoc as RefLoc
    from hmmufotu_tpu_torch.phylo import PTLoc
    ref, port = loaded(prefixes[model])
    assert ref.msg_up.dtype == np.float64
    assert port.msg_up.dtype == port.msg_down.dtype == np.float32
    assert (ref.dg is None) == (model == "gtr")
    if reader in ("estimate_seq", "place_seq"):
        for u, start, end, seq in reads(ref):
            # the read's own leaf, its parent and a sibling subtree
            for v in (u, int(ref.parent[u]), int(ref.parent[ref.parent[u]])):
                if ref.parent[v] < 0:
                    continue
                a = ref.estimate_seq(seq, RefLoc(start, end, v, 0.01))
                b = port.estimate_seq(seq, PTLoc(start, end, v, 0.01))
                for x, y in zip(placement_fields(a), placement_fields(b)):
                    same(x, y)
                if reader == "place_seq":
                    a = ref.place_seq(seq, a)
                    b = port.place_seq(seq, b)
                    for x, y in zip(placement_fields(a),
                                    placement_fields(b)):
                        same(x, y)
    elif reader == "node_loglik":
        leaf = next(u for u in range(ref.num_nodes) if ref.is_leaf(u)
                    and ref.parent[u] >= 0)
        inner = next(u for u in range(ref.num_nodes)
                     if not ref.is_leaf(u) and ref.parent[u] >= 0)
        for u in (ref.root, inner, leaf):
            same(ref.node_loglik(u), port.node_loglik(u))
            # the sum CLI's consensus reads it
            count = np.ones((4, ref.cs_len))
            same(ref.infer_post_cs(u, count), port.infer_post_cs(u, count))
    elif reader == "tree_loglik":
        same(ref.tree_loglik(), port.tree_loglik())
        same(ref.tree_loglik(100, 400), port.tree_loglik(100, 400))
    elif reader == "infer_seq":
        inner = np.array([not ref.is_leaf(u) for u in range(ref.num_nodes)])
        for t in (ref, port):
            t.has_seq[inner] = False
            t.seqs[inner] = -1
            t.infer_seq()
        same(ref.seqs, port.seqs)
        same(ref.has_seq, port.has_seq)
    elif reader == "estimate_num_mutations":
        same(ref.estimate_num_mutations(), port.estimate_num_mutations())
    elif reader == "sim":
        from hmmufotu_tpu.cli.sim import main as ref_sim
        from hmmufotu_tpu_torch.cli.sim import main as port_sim
        argv = ["-N", "40", "-S", "7", "--mean-size", "400", "-l", "150"]
        assert ref_sim([prefixes[model], str(tmp_path / "ref.fa"),
                        "-m", str(tmp_path / "ref2.fa")] + argv) == 0
        assert port_sim([prefixes[model], str(tmp_path / "port.fa"),
                         "-m", str(tmp_path / "port2.fa")] + argv) == 0
        for a, b in (("ref.fa", "port.fa"), ("ref2.fa", "port2.fa")):
            want = (tmp_path / a).read_bytes()
            assert sum(ln.startswith(b">")
                       for ln in want.splitlines()) == 40
            assert (tmp_path / b).read_bytes() == want
    else:
        from hmmufotu_tpu.io.reference_format import \
            save_reference_ptu as ref_save
        from hmmufotu_tpu_torch.io.reference_format import \
            save_reference_ptu
        ref_save(ref, str(tmp_path / "ref.ptu"))
        save_reference_ptu(port, str(tmp_path / "port.ptu"))
        assert (tmp_path / "port.ptu").read_bytes() \
            == (tmp_path / "ref.ptu").read_bytes()


def state_bytes(tree) -> int:
    return sum(v.nbytes for v in vars(tree).values()
               if isinstance(v, np.ndarray))


@pytest.mark.parametrize("model", list(MODELS))
def test_load_makes_no_f64_copy_of_the_messages(prefixes, model):
    from hmmufotu_tpu_torch.phylo import PTUnrooted
    tracemalloc.start()
    try:
        tree = PTUnrooted.load(prefixes[model] + ".ptu.npz")
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    msgs = tree.msg_up.nbytes + tree.msg_down.nbytes
    assert tree.msg_up.dtype == np.float32
    assert msgs > 0.8 * state_bytes(tree)
    assert peak <= LOAD_PEAK_RATIO * state_bytes(tree), \
        (peak, state_bytes(tree))


@pytest.mark.parametrize("model", list(MODELS))
def test_reference_load_reads_a_port_saved_file(prefixes, tmp_path, model):
    """The port's save (zlib level 1, its own zip writer) is read back by
    the reference package's load to the port's state, the messages
    widened; by the port's own load to the same arrays; and the file has
    np.savez_compressed's members."""
    import zipfile
    from hmmufotu_tpu.phylo import PTUnrooted as RefTree
    from hmmufotu_tpu_torch.phylo import PTUnrooted
    _, port = loaded(prefixes[model])
    path = str(tmp_path / "port.ptu.npz")
    port.save(path)
    ref = RefTree.load(path)
    again = PTUnrooted.load(path)
    for k, v in vars(port).items():
        if isinstance(v, np.ndarray):
            same(v, getattr(again, k))
            want = getattr(ref, k)
            if k in ("msg_up", "msg_down"):
                v = np.float64(v)
            same(want, v)
        elif k not in ("model", "dg", "_children", "msg_read_dtype"):
            assert getattr(ref, k) == v == getattr(again, k), k
    assert (ref.dg is None) == (port.dg is None) == (again.dg is None)
    if port.dg is not None:
        assert ref.dg.alpha == port.dg.alpha == again.dg.alpha
        same(np.asarray(ref.dg.rates), np.asarray(port.dg.rates))
    same(ref.model.pi, port.model.pi)
    with zipfile.ZipFile(path) as a, \
            zipfile.ZipFile(prefixes[model] + ".ptu.npz") as b:
        assert a.namelist() == b.namelist()
        assert {i.compress_type for i in a.infolist()} \
            == {zipfile.ZIP_DEFLATED}
