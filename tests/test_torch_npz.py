"""The port's npz writer and reader (hmmufotu_tpu_torch/io/npz.py) on the
70_otus DB, and merge -t's topology-only read.

A DB the port's build CLI wrote reads back to bit-equal arrays through
the port's reader, np.load and the reference package's loaders, and
passes zipfile's testzip(); files the reference package wrote read
through np.load; a file's bytes do not depend on the writer's threads;
members over many chunks; corrupt chunks raise; the f32 and no-copy rules
of PTUnrooted.load hold on the chunked path; merge -t reads no message
and writes the reference CLI's newick, with Database.load's file
errors."""

import os
import shutil
import subprocess
import sys
import tracemalloc
import zipfile

import numpy as np
import pytest

from test_torch_cli_tools import (assignment, otu_table,  # noqa: F401
                                  run_pair, sim_reads)
from test_torch_pipeline import db_prefix, one_torch_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ_FILES = [".msa.npz", ".csfm.npz", ".ptu.npz"]
SMALL_CHUNK = 4096       # bytes a chunk where a test spans many chunks


@pytest.fixture(scope="module")
def port_prefix(tmp_path_factory):
    """The 70_otus DB, built once by the port's build CLI (its writer)."""
    from hmmufotu_tpu_torch.cli.build import main as build_main
    prefix = str(tmp_path_factory.mktemp("port_db") / "70_otus")
    assert build_main([os.path.join(FIXTURES, "70_otus.fasta"),
                       os.path.join(FIXTURES, "70_otus.tree"),
                       "-a", os.path.join(FIXTURES, "70_otus_taxonomy.txt"),
                       "-n", prefix, "-s", "GTR"], device="cpu") == 0
    return prefix


def same(a, b):
    """The same dtype, shape, order and bytes."""
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.flags.f_contiguous == b.flags.f_contiguous
    assert a.tobytes("A") == b.tobytes("A")


def read_all(path, how):
    from hmmufotu_tpu_torch.io.npz import NpzReader
    opener = NpzReader if how == "port" else (
        lambda p: np.load(p, allow_pickle=False))
    with opener(path) as z:
        return {k: z[k] for k in z.files}


def array_state(obj) -> dict:
    return {k: v for k, v in vars(obj).items() if isinstance(v, np.ndarray)}


def loaders(suffix):
    """(the reference package's loader, the port's) of one file kind."""
    if suffix == ".msa.npz":
        from hmmufotu_tpu.msa import MSA as Ref
        from hmmufotu_tpu_torch.msa import MSA as Port
    elif suffix == ".csfm.npz":
        from hmmufotu_tpu.index import CSFMIndex as Ref
        from hmmufotu_tpu_torch.index import CSFMIndex as Port
    else:
        from hmmufotu_tpu.phylo import PTUnrooted as Ref
        from hmmufotu_tpu_torch.phylo import PTUnrooted as Port
    return Ref.load, Port.load


@pytest.mark.parametrize("suffix", NPZ_FILES)
def test_port_file_reads_the_same_everywhere(port_prefix, suffix):
    """Every member has its chunk table; testzip() finds no bad member;
    the port's reader and np.load give bit-equal arrays; the reference
    package's loader gives the port's loader's state (the messages
    widened to f64, as it widens them)."""
    from hmmufotu_tpu_torch.io.npz import chunk_table
    path = port_prefix + suffix
    with zipfile.ZipFile(path) as z:
        assert z.testzip() is None
        assert all(chunk_table(i) is not None for i in z.infolist())
    got, want = read_all(path, "port"), read_all(path, "np.load")
    assert sorted(got) == sorted(want)
    for k in want:
        same(got[k], want[k])
    ref_load, port_load = loaders(suffix)
    ref, port = array_state(ref_load(path)), array_state(port_load(path))
    assert sorted(ref) == sorted(port)
    for k, v in port.items():
        same(ref[k], np.float64(v) if k in ("msg_up", "msg_down") else v)


@pytest.mark.parametrize("suffix", NPZ_FILES)
def test_reference_file_reads_through_np_load(db_prefix, suffix,  # noqa: F811
                                              monkeypatch):
    """A file the reference package wrote has no chunk table: the port's
    reader gives np.load's arrays by np.load's own path, and the port's
    loader reads it."""
    from hmmufotu_tpu_torch.io import npz
    path = db_prefix + suffix
    with zipfile.ZipFile(path) as z:
        assert all(npz.chunk_table(i) is None for i in z.infolist())

    def chunked(*a):
        raise AssertionError("the chunked path read a file without tables")

    monkeypatch.setattr(npz.NpzReader, "_read_chunked", chunked)
    got, want = read_all(path, "port"), read_all(path, "np.load")
    assert sorted(got) == sorted(want)
    for k in want:
        same(got[k], want[k])
    loaders(suffix)[1](path)


def tree_arrays(prefix):
    return read_all(prefix + ".ptu.npz", "port")


@pytest.mark.parametrize("chunk", [None, SMALL_CHUNK],
                         ids=["default_chunk", "small_chunk"])
def test_bytes_do_not_depend_on_threads(port_prefix, tmp_path, chunk,
                                        monkeypatch):
    from hmmufotu_tpu_torch.io import npz
    if chunk:
        monkeypatch.setattr(npz, "CHUNK_BYTES", chunk)
    arrays = tree_arrays(port_prefix)
    one = npz.write_npz(str(tmp_path / "one"), arrays, threads=1)
    four = npz.write_npz(str(tmp_path / "four.npz"), arrays, threads=4)
    assert one.endswith(".npz")
    with open(one, "rb") as a, open(four, "rb") as b:
        assert a.read() == b.read()


def test_member_over_many_chunks(port_prefix, tmp_path, monkeypatch):
    """With chunks of SMALL_CHUNK bytes the messages span hundreds of
    them: the port's save reads back bit-equal through the port's
    reader, np.load and the reference package's load."""
    from hmmufotu_tpu.phylo import PTUnrooted as RefTree
    from hmmufotu_tpu_torch.io import npz
    from hmmufotu_tpu_torch.phylo import PTUnrooted
    monkeypatch.setattr(npz, "CHUNK_BYTES", SMALL_CHUNK)
    tree = PTUnrooted.load(port_prefix + ".ptu.npz")
    path = str(tmp_path / "small_chunks.ptu.npz")
    tree.save(path)
    with zipfile.ZipFile(path) as z:
        assert z.testzip() is None
        table = npz.chunk_table(z.getinfo("msg_up.npy"))
    assert table[0] == SMALL_CHUNK
    assert len(table[1]) == 1 + -(-tree.msg_up.nbytes // SMALL_CHUNK) > 100
    got, want = read_all(path, "port"), read_all(path, "np.load")
    for k in want:
        same(got[k], want[k])
    same(got["msg_up"], tree.msg_up)
    same(RefTree.load(path).msg_down, np.float64(tree.msg_down))


def corrupt(path, out, where):
    """A copy of path with one fault in msg_up: a flipped byte in a data
    chunk or in the .npy header's chunk, or one byte moved from the second
    data chunk to the first in the chunk table (the sizes' sum kept)."""
    from hmmufotu_tpu_torch.io import npz
    data = bytearray(open(path, "rb").read())
    with zipfile.ZipFile(path) as z:
        info = z.getinfo("msg_up.npy")
    _, sizes = npz.chunk_table(info)
    start = info.header_offset + 30 + len(info.filename) + 20
    if where == "data":
        data[start + sizes[0] + sizes[1] // 2] ^= 0x40
    elif where == "header":
        data[start + sizes[0] // 2] ^= 0x40
    else:
        # the central entry's name, then (a small file: no zip64 field)
        # the table's id and length, its head, then the chunk sizes
        at = data.rfind(info.filename.encode()) + len(info.filename)
        assert int.from_bytes(data[at:at + 2], "little") \
            == npz.CHUNK_TABLE_ID
        at += 4 + npz._TABLE_HEAD.size + 4
        for k, d in ((0, 1), (4, -1)):
            v = int.from_bytes(data[at + k:at + k + 4], "little")
            data[at + k:at + k + 4] = (v + d).to_bytes(4, "little")
    open(out, "wb").write(bytes(data))


@pytest.mark.parametrize("where", ["data", "header", "table"])
def test_corrupt_chunk_raises(port_prefix, tmp_path, where, monkeypatch):
    from hmmufotu_tpu_torch.io import npz
    from hmmufotu_tpu_torch.phylo import PTUnrooted
    monkeypatch.setattr(npz, "CHUNK_BYTES", SMALL_CHUNK)
    path = str(tmp_path / "t.ptu.npz")
    PTUnrooted.load(port_prefix + ".ptu.npz").save(path)
    bad = str(tmp_path / "bad.ptu.npz")
    corrupt(path, bad, where)
    with npz.NpzReader(bad) as z:
        with pytest.raises(zipfile.BadZipFile):
            z["msg_up"]
        same(z["msg_down"], read_all(path, "port")["msg_down"])
    with pytest.raises(zipfile.BadZipFile):
        PTUnrooted.load(bad)


def test_chunked_load_keeps_f32_and_makes_no_copy(port_prefix, tmp_path,
                                                  monkeypatch):
    """PTUnrooted.load's rules on the chunked path: the messages stay
    f32, the host readers read them as f64, and the load's peak stays
    within test_torch_load_f32.py's ratio of the state it returns."""
    from test_torch_load_f32 import LOAD_PEAK_RATIO, state_bytes
    from hmmufotu_tpu_torch.io import npz
    from hmmufotu_tpu_torch.phylo import PTUnrooted
    monkeypatch.setattr(npz, "CHUNK_BYTES", 64 << 10)
    path = str(tmp_path / "t.ptu.npz")
    PTUnrooted.load(port_prefix + ".ptu.npz").save(path)
    tracemalloc.start()
    try:
        tree = PTUnrooted.load(path)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert tree.msg_up.dtype == tree.msg_down.dtype == np.float32
    assert tree.msg_read_dtype == np.float64
    assert tree.up_rows(0, slice(0, 8)).dtype == np.float64
    assert peak <= LOAD_PEAK_RATIO * state_bytes(tree), \
        (peak, state_bytes(tree))


def test_merge_tree_reads_only_the_topology(port_prefix, otu_table,  # noqa
                                            tmp_path, monkeypatch):
    """merge -t on the port's DB reads meta, parent and brlen of the
    .ptu.npz and the format tags of the other npz files, no message, and
    writes the reference merge CLI's table and newick (whose whole load
    reads the port's files)."""
    from hmmufotu_tpu.cli.merge import main as ref_merge
    from hmmufotu_tpu.cli.subset import main as ref_subset
    from hmmufotu_tpu_torch.cli.merge import main as port_merge
    from hmmufotu_tpu_torch.io.npz import NpzReader
    sub = str(tmp_path / "sub.tsv")
    assert ref_subset([otu_table, sub, "-n", "10", "-S", "1"]) == 0
    read, get = [], NpzReader.__getitem__

    def spy(z, key):
        read.append((os.path.basename(z.path), key))
        return get(z, key)

    monkeypatch.setattr(NpzReader, "__getitem__", spy)
    out, tree = str(tmp_path / "merged.tsv"), str(tmp_path / "merged.tree")
    ref, port = run_pair(ref_merge, port_merge,
                         [otu_table, sub, "-o", out, "-db", port_prefix,
                          "-t", tree], [out, tree])
    assert port == ref and ref[1].endswith(b";")
    assert sorted(read) == [("70_otus.csfm.npz", "fmt"),
                            ("70_otus.msa.npz", "fmt"),
                            ("70_otus.ptu.npz", "brlen"),
                            ("70_otus.ptu.npz", "meta"),
                            ("70_otus.ptu.npz", "parent")]


def merge_argv(otu_table, prefix, tmp_path):  # noqa: F811
    return [otu_table, otu_table, "-o", str(tmp_path / "m.tsv"), "-db",
            prefix, "-t", str(tmp_path / "m.tree")]


def copy_db(prefix, tmp_path):
    out = str(tmp_path / "copy")
    for suf in NPZ_FILES + [".hmm"]:
        shutil.copy(prefix + suf, out + suf)
    return out


@pytest.mark.parametrize("suffix", [".hmm", ".ptu.npz"])
def test_merge_tree_missing_file(port_prefix, otu_table, tmp_path,  # noqa
                                 suffix):
    """A missing DB file stops merge -t with Database.load's error."""
    from hmmufotu_tpu_torch.cli.merge import main as port_merge
    from hmmufotu_tpu_torch.db import Database
    prefix = copy_db(port_prefix, tmp_path)
    os.unlink(prefix + suffix)
    with pytest.raises(FileNotFoundError) as want:
        Database.load(prefix)
    with pytest.raises(FileNotFoundError) as got:
        port_merge(merge_argv(otu_table, prefix, tmp_path))
    assert str(got.value) == str(want.value) and suffix in str(got.value)


@pytest.mark.parametrize("suffix", NPZ_FILES)
def test_merge_tree_wrong_format_tag(port_prefix, otu_table,  # noqa: F811
                                     tmp_path, suffix):
    """A DB file of another kind (its format tag changed) stops merge -t
    with Database.load's error."""
    from hmmufotu_tpu_torch.cli.merge import main as port_merge
    from hmmufotu_tpu_torch.db import Database
    from hmmufotu_tpu_torch.io.npz import write_npz
    prefix = copy_db(port_prefix, tmp_path)
    arrays = read_all(prefix + suffix, "port")
    if suffix == ".ptu.npz":
        arrays["meta"] = np.array([str(arrays["meta"][0]).replace(
            "hmmufotu-tpu-ptu-v1", "hmmufotu-tpu-msa-v1")])
    else:
        arrays["fmt"] = np.array(["hmmufotu-tpu-ptu-v1"])
    write_npz(prefix + suffix, arrays)
    with pytest.raises(ValueError) as want:
        Database.load(prefix)
    with pytest.raises(ValueError) as got:
        port_merge(merge_argv(otu_table, prefix, tmp_path))
    assert str(got.value) == str(want.value)
    assert "format tag" in str(got.value)


def test_npz_times_script_on_the_cpu(port_prefix, tmp_path):
    """scripts/torch_npz_times.py on the 70_otus tree: rc 0, four whole
    reads of one digest, four saves of one file's bytes."""
    import json
    out = str(tmp_path / "t.json")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_npz_times.py"),
         "--db", port_prefix, "--writer-nodes", "100", "--device", "cpu",
         "--out", out], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got == json.load(open(out))
    assert [x["reader"] for x in got["load"]] == ["np.load", "port", "port",
                                                  "np.load"]
    assert got["load_digests_equal"] and got["save_bytes_equal"]
    assert [x["threads"] for x in got["save"]] == [
        1, got["host_threads"], got["host_threads"], 1]
    assert got["save_nodes"] == 100 and got["card"] is None
