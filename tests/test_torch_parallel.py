"""The port's parallel layer on the CPU: sharded placement on an 8-shard
CPU mesh, the tree-sharded placer and its host merge, the sharded
assignment step and OTU counts, assign --mesh/--mesh-tree, the
multi-process assign over gloo, the argument checks of those flags, and
the kernel build across processes.

Sharded placement must give the single-device placement: per-read work
does not depend on how the batch is split (tests/test_sharding.py's
gates: the same c node, loglik within 1e-5 relative; for the tree-sharded
merge also the same a node and Q values within 0.05).  Against the
reference package's mesh results the port is held to the tolerances of
tests/test_torch_pipeline.py (the same nodes, logliks within 1e-4
relative + 0.5), as the two packages sum sites in different orders."""

import functools
import logging
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from conftest import REPO_ROOT, run_on_cpu_mesh
from test_torch_cli_chimera import chimera_reads  # noqa: F401
from test_torch_pipeline import (LL_ATOL, LL_RTOL, db_prefix,  # noqa: F401
                                 one_torch_thread, simulate_reads)

SHARDS = 8
B = 16

# the fixture tree and seeded reads of tests/test_sharding.py:39-130
TREE_AND_READS = """
import os, numpy as np
from {pkg}.msa import MSA
from {pkg}.phylo import PTUnrooted, parse_newick, JC69
FIX = os.path.join("tests", "fixtures")
msa = MSA.load_fasta(os.path.join(FIX, "70_otus.fasta")); msa.prune()
tree = PTUnrooted.from_newick(parse_newick(
    open(os.path.join(FIX, "70_otus.tree")).read()))
tree.load_msa(msa); tree.fix_branch_length(1e-5); tree.calc_node_height()
tree.load_annotation(os.path.join(FIX, "70_otus_taxonomy.txt"))
tree.format_name(); tree.annotate()
tree.model = JC69(); tree.evaluate(); tree.infer_seq()

def reads(seed, mut_rate, B={B}):
    rng = np.random.default_rng(seed)
    leaves = [u for u in range(tree.num_nodes)
              if tree.is_leaf(u) and tree.msa_id[u] >= 0]
    seqs = np.full((B, tree.cs_len), -2, np.int8)
    starts = np.zeros(B, np.int32); ends = np.zeros(B, np.int32)
    for r in range(B):
        u = int(rng.choice(leaves)); codes = tree.seqs[u]
        pos = np.nonzero(codes >= 0)[0]
        st = int(rng.integers(0, max(1, len(pos) - 210)))
        w = pos[st:st + 200]
        piece = codes[w].copy()
        if mut_rate:
            mut = rng.random(len(piece)) < mut_rate
            piece[mut] = rng.integers(0, 4, int(mut.sum()))
        seqs[r, w] = piece; starts[r], ends[r] = w[0], w[-1]
    return seqs, starts, ends
"""

# the reference package on its 8-device CPU mesh: the data-parallel
# summary (C = 32, seed 0, no mutations) and the tree-sharded merge
# (C = 24, seed 5, 3% mutations), as tests/test_sharding.py runs them
REF_MESH = TREE_AND_READS.format(pkg="hmmufotu_tpu", B=B) + """
from hmmufotu_tpu.phylo.placement import DevicePlacer
from hmmufotu_tpu.parallel import make_mesh, sharded_place_batch
from hmmufotu_tpu.parallel.sharding import sharded_place_batch_tree
from hmmufotu_tpu import pipeline as pl
mesh = make_mesh({n})
seqs, starts, ends = reads(0, 0.0)
data = np.asarray(sharded_place_batch(
    mesh, DevicePlacer(tree, window=256, max_nseed=32), seqs, starts, ends))
seqs, starts, ends = reads(5, 0.03)
placer = DevicePlacer(tree, window=256, max_nseed=24)
union = sharded_place_batch_tree(mesh, placer, seqs, starts, ends)
merged = pl.merge_mp_candidates(tree, union, np.ones({B}, bool), starts,
                                ends, C=24)
tree_rows = np.array([[p.c_node, p.a_node, p.loglik, p.q_place, p.q_taxon]
                      for p in merged])
np.savez(r"{out}", data=data, tree=tree_rows, cand=union["cand"])
print("REF_MESH_OK")
"""


@pytest.fixture(scope="module")
def port_tree():
    scope = {}
    exec(TREE_AND_READS.format(pkg="hmmufotu_tpu_torch", B=B), scope)
    return scope["tree"], scope["reads"]


@pytest.fixture(scope="module")
def ref_mesh(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("refmesh") / "ref.npz")
    res = run_on_cpu_mesh(REF_MESH.format(n=SHARDS, B=B, out=out),
                          n_devices=SHARDS, timeout=600)
    assert "REF_MESH_OK" in res.stdout, res.stderr[-3000:]
    return np.load(out)


def test_sharded_place_batch_matches_single_and_reference(port_tree,
                                                          ref_mesh):
    from hmmufotu_tpu_torch.parallel import make_mesh, sharded_place_batch
    from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
    tree, reads = port_tree
    seqs, starts, ends = reads(0, 0.0)
    placer = DevicePlacer(tree, window=256, max_nseed=32, device="cpu")
    single = placer.place_batch(seqs, starts, ends,
                                summary_only=True)["summary"]
    mesh = make_mesh(SHARDS, device="cpu")
    assert mesh.size == SHARDS and mesh.devices[0].type == "cpu"
    sharded = sharded_place_batch(mesh, placer, seqs, starts, ends)
    assert sharded.shape == (B, 12)
    assert (sharded[:, 0] == single[:, 0]).all()
    np.testing.assert_allclose(sharded[:, 5], single[:, 5], rtol=1e-5)
    ref = ref_mesh["data"]
    assert (sharded[:, [0, 1, 2, 11]] == ref[:, [0, 1, 2, 11]]).all()
    np.testing.assert_allclose(sharded[:, 5], ref[:, 5], rtol=LL_RTOL,
                               atol=LL_ATOL)


def test_tree_sharded_merge_matches_single_and_reference(port_tree,
                                                         ref_mesh):
    from hmmufotu_tpu_torch import pipeline as pl
    from hmmufotu_tpu_torch.parallel import (make_mesh,
                                             sharded_place_batch_tree)
    from hmmufotu_tpu_torch.phylo.placement import DevicePlacer
    tree, reads = port_tree
    seqs, starts, ends = reads(5, 0.03)
    placer = DevicePlacer(tree, window=256, max_nseed=24, device="cpu")
    single = placer.place_batch(seqs, starts, ends,
                                summary_only=True)["summary"]
    union = sharded_place_batch_tree(make_mesh(SHARDS, device="cpu"),
                                     placer, seqs, starts, ends)
    assert union["cand"].shape == (B, 24 * SHARDS)
    assert union["cand"].dtype == np.float32
    # the same candidates on each shard; within a shard both packages
    # order lanes by their f32 estimates, which may tie differently
    for k in range(SHARDS):
        blk = slice(24 * k, 24 * (k + 1))
        assert (np.sort(union["cand"][:, blk], 1)
                == np.sort(ref_mesh["cand"][:, blk], 1)).all()
    merged = pl.merge_mp_candidates(tree, union, np.ones(B, bool), starts,
                                    ends, C=24)
    ref = ref_mesh["tree"]
    for r, p in enumerate(merged):
        assert p is not None
        assert (p.c_node, p.a_node) == (int(single[r, 0]),
                                        int(single[r, 2]))
        np.testing.assert_allclose(p.loglik, single[r, 5], rtol=1e-5)
        np.testing.assert_allclose(p.q_place, single[r, 6], atol=0.05)
        np.testing.assert_allclose(p.q_taxon, single[r, 7], atol=0.05)
        assert (p.c_node, p.a_node) == (int(ref[r, 0]), int(ref[r, 1]))
        assert p.loglik == pytest.approx(ref[r, 2], rel=LL_RTOL,
                                         abs=LL_ATOL)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_sharded_otu_accumulate_matches_bincount(n_shards):
    from hmmufotu_tpu_torch.parallel import (make_mesh,
                                             sharded_otu_accumulate)
    ids = np.random.default_rng(0).integers(0, 7, size=64)
    counts = sharded_otu_accumulate(make_mesh(n_shards, device="cpu"),
                                    ids, 7)
    assert counts.dtype == torch.int32
    assert (counts.numpy() == np.bincount(ids, minlength=7)).all()


def toy_hmm_arrays(K):
    """The cost arrays of __graft_entry__._toy_device_hmm, as numpy."""
    rng = np.random.default_rng(0)

    def costs(*shape):
        return -np.log(rng.dirichlet(np.ones(shape[-1]), size=shape[:-1]))

    em = costs(K + 1, 4).T
    ei = costs(K + 1, 4).T
    t = -np.log(rng.dirichlet(np.ones(3), size=(K + 1, 3)))
    return dict(EM=em, EI=ei, TMM=t[:, 0, 0], TMI=t[:, 0, 1],
                TMD=t[:, 0, 2], TIM=t[:, 1, 0], TII=t[:, 1, 1],
                TDM=t[:, 2, 0], TDD=t[:, 2, 2],
                entry=np.full(K + 1, 3.0), exit=np.full(K + 1, 3.0),
                t_NN=0.1, t_NB=0.05, t_CC=0.1, t_EC=0.0)


def test_sharded_assign_step_matches_reference():
    """__graft_entry__.dryrun_multichip's toy step (K 32, 24 rows, 16
    nodes, 5 taxa) on both packages' meshes."""
    import jax
    import jax.numpy as jnp
    from hmmufotu_tpu.hmm.viterbi import DeviceHMM as RefHMM
    from hmmufotu_tpu.hmm.viterbi import full_dp_regions
    from hmmufotu_tpu.parallel import make_mesh as ref_mesh
    from hmmufotu_tpu.parallel import sharded_assign_step as ref_step
    from hmmufotu_tpu_torch.hmm.viterbi import DeviceHMM
    from hmmufotu_tpu_torch.parallel import make_mesh, sharded_assign_step
    K, n_rows, n_nodes, n_taxa = 32, 24, 16, 5
    n_dev = len(jax.devices())
    Bt = 2 * n_dev
    arrays = toy_hmm_arrays(K)
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, size=(Bt, n_rows)).astype(np.int8)
    lengths = np.full(Bt, n_rows, np.int32)
    regions = np.tile(full_dp_regions(n_rows, K)[None], (Bt, 1, 1))
    node_seqs = rng.integers(-1, 4, size=(n_nodes, n_rows)).astype(np.int8)
    anno = rng.integers(0, n_taxa, size=n_nodes).astype(np.int32)
    want = ref_step(
        ref_mesh(n_dev), RefHMM(**{k: jnp.asarray(v, jnp.float32)
                                  for k, v in arrays.items()}),
        jnp.asarray(node_seqs), jnp.asarray(anno), n_taxa,
        jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(regions),
        n_rows)
    got = sharded_assign_step(
        make_mesh(SHARDS, device="cpu"),
        DeviceHMM(**{k: torch.as_tensor(np.asarray(v, np.float32))
                     for k, v in arrays.items()}),
        node_seqs, anno, n_taxa, codes, lengths, regions, n_rows)
    scores, best, counts = (np.asarray(x) for x in want)
    np.testing.assert_allclose(got[0].numpy(), scores, rtol=1e-5)
    assert (got[1].numpy() == best).all()
    assert (got[2].numpy() == counts).all() and counts.sum() == Bt


# ---------------------------------------------------------------------------
# the assign CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reads_fa(db_prefix, tmp_path_factory):  # noqa: F811
    from hmmufotu_tpu_torch.db import Database
    reads = simulate_reads(Database.load(db_prefix).ptu, 24, seed=9)
    path = tmp_path_factory.mktemp("par") / "reads.fasta"
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    return str(path)


def body(path):
    return [line for line in open(path)
            if not line.startswith("#") and not line.startswith("id\t")]


def errors(caplog):
    return [r.getMessage() for r in caplog.records
            if r.levelno >= logging.ERROR]


@pytest.mark.parametrize("flags, rc", [
    (["--mesh", "--mesh-tree"], 1),
    (["--mesh", "--resident-window", "700"], 1),
    (["--mesh-tree", "--resident-window", "700"], 1),
    (["--num-processes", "2"], 1),
    (["--num-processes", "2", "--process-id", "2"], 1),
    (["--num-processes", "2", "--process-id", "-1"], 1),
    (["--num-processes", "2", "--process-id", "0", "--resume"], 1),
    (["--num-processes", "2", "--process-id", "1", "-S", "0"], 1),
    (["--coordinator", "localhost:1234"], 0),
    (["--process-id", "0", "--num-processes", "1"], 0),
], ids=["mesh_and_tree", "mesh_window", "tree_window", "no_process_id",
        "process_id_2_of_2", "process_id_negative", "resume", "seed",
        "coordinator_alone", "one_process"])
def test_assign_flag_checks_match_reference(db_prefix, reads_fa,  # noqa: F811
                                            tmp_path, caplog, flags, rc):
    """The CLI's checks of the mesh and multi-process flags return what
    the reference CLI returns, with the same message; --coordinator and
    --process-id are ignored for one process, and the rows are those of
    a run without them."""
    from hmmufotu_tpu.cli.assign import main as ref_main
    from hmmufotu_tpu_torch.cli.assign import main
    got = {}
    for tag, fn in (("ref", ref_main),
                    ("port", functools.partial(main, device="cpu"))):
        caplog.clear()
        out = tmp_path / f"{tag}.tsv"
        argv = [db_prefix, reads_fa, "-o", str(out), "-s", "1"] + flags
        got[tag] = (fn(argv), errors(caplog))
        if rc == 0:
            got[tag] += (len(body(out)),)
    assert got["port"] == got["ref"]
    assert got["port"][0] == rc and bool(got["port"][1]) == (rc != 0)


def rows_agree(got, want):
    """Rows of two assignment TSVs: the same ids and alignment columns,
    the same branch and taxon, logliks within the pipeline tolerances."""
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got, want):
        assert g[2:10] == w[2:10], g[0]
        assert (g[10], g[12], g[13]) == (w[10], w[12], w[13]), g[0]
        assert float(g[15]) == pytest.approx(float(w[15]), rel=LL_RTOL,
                                             abs=LL_ATOL)


def split_rows(path):
    return [line.rstrip("\n").split("\t") for line in body(path)]


@pytest.mark.parametrize("flag", ["--mesh", "--mesh-tree"])
def test_assign_mesh_rows_match_reference(db_prefix, reads_fa,  # noqa: F811
                                          tmp_path, flag):
    """assign --mesh / --mesh-tree on the port's 8-shard CPU mesh against
    the reference CLI with the same flag on its CPU mesh, and against the
    port's run without a mesh."""
    from hmmufotu_tpu.cli.assign import main as ref_main
    from hmmufotu_tpu_torch.cli.assign import main
    paths = {k: str(tmp_path / f"{k}.tsv") for k in ("ref", "port", "one")}
    argv = [db_prefix, reads_fa, "-s", "1", "-b", "12"]
    assert ref_main(argv + ["-o", paths["ref"], flag]) == 0
    assert main(argv + ["-o", paths["port"], flag], device="cpu") == 0
    assert main(argv + ["-o", paths["one"]], device="cpu") == 0
    port = split_rows(paths["port"])
    assert len(port) == 24
    rows_agree(port, split_rows(paths["ref"]))
    rows_agree(port, split_rows(paths["one"]))


# ---------------------------------------------------------------------------
# several processes
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_procs(codes, timeout=300):
    """Run python snippets as concurrent processes (one torch thread
    each); returns their CompletedProcess, in order."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO_ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(c)],
                              env=env, cwd=REPO_ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for c in codes]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            results.append(subprocess.CompletedProcess(
                p.args, p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_two_processes_match_one(db_prefix, tmp_path, paired):  # noqa: F811
    """assign --num-processes 2 over gloo: the data rows byte-equal to a
    one-process run, in read order, the --align-out files one a process
    (tests/test_multihost.py:77-153).  The paired-end run gathers in
    256-byte chunks, many rounds."""
    from hmmufotu_tpu_torch.cli.assign import main
    from hmmufotu_tpu_torch.cli.sim import main as sim_main
    r1, r2 = str(tmp_path / "r1.fasta"), str(tmp_path / "r2.fasta")
    sim = [db_prefix, r1, "-N", "16", "-S", "5"]
    sim += ["-m", r2, "--mean-size", "400", "--sd-size", "10"] if paired \
        else ["--mean-size", "250", "--sd-size", "10"]
    assert sim_main(sim) == 0
    reads = [r1, r2] if paired else [r1]
    one = str(tmp_path / "one.tsv")
    assert main([db_prefix, *reads, "-o", one], device="cpu") == 0
    multi, aln = str(tmp_path / "multi.tsv"), str(tmp_path / "aln.fa")
    port = free_port()
    chunk = "256" if paired else "64 << 20"
    codes = [f"""
        import sys
        from hmmufotu_tpu_torch.parallel import distributed
        from hmmufotu_tpu_torch.cli.assign import main
        gather = distributed.gather_host_text
        distributed.gather_host_text = \\
            lambda text: gather(text, chunk_bytes={chunk})
        sys.exit(main({[db_prefix, *reads]!r} + [
            "-o", {multi!r}, "-a", {aln!r},
            "--coordinator", "localhost:{port}", "--num-processes", "2",
            "--process-id", "{pid}"], device="cpu"))
        """ for pid in (0, 1)]
    for r in run_procs(codes):
        assert r.returncode == 0, r.stderr[-3000:]
    assert body(multi) == body(one) and len(body(one)) == 16
    assert os.path.exists(aln + ".p0") and os.path.exists(aln + ".p1")
    assert not os.path.exists(aln)


def test_two_processes_chimera_match_one(db_prefix, chimera_reads,  # noqa: F811
                                         tmp_path):
    """assign -C --chimera-out with --num-processes 2 over gloo: the
    gathered data rows byte-equal to one process's; the --chimera-out
    files are not gathered, each process writes its own .p<i>, and the
    bodies of .p0 then .p1 are one process's chimera rows."""
    from hmmufotu_tpu_torch.cli.assign import main
    flags = ["-C", "-s", "1"]
    one, one_chi = str(tmp_path / "one.tsv"), str(tmp_path / "one_chi.tsv")
    assert main([db_prefix, chimera_reads, "-o", one, "--chimera-out",
                 one_chi, *flags], device="cpu") == 0
    multi, chi = str(tmp_path / "multi.tsv"), str(tmp_path / "chi.tsv")
    port = free_port()
    codes = [f"""
        import sys
        from hmmufotu_tpu_torch.cli.assign import main
        sys.exit(main({[db_prefix, chimera_reads, *flags]!r} + [
            "-o", {multi!r}, "--chimera-out", {chi!r},
            "--coordinator", "localhost:{port}", "--num-processes", "2",
            "--process-id", "{pid}"], device="cpu"))
        """ for pid in (0, 1)]
    for r in run_procs(codes):
        assert r.returncode == 0, r.stderr[-3000:]
    assert body(multi) == body(one) and len(body(one)) > 0
    assert not os.path.exists(chi)
    parts = body(chi + ".p0") + body(chi + ".p1")
    assert parts == body(one_chi) and len(parts) > 0


def test_multihost_otu_psum_sums_processes():
    port = free_port()
    codes = [f"""
        import numpy as np
        from hmmufotu_tpu_torch.parallel.distributed import (
            host_shard, init_distributed, multihost_otu_psum)
        init_distributed("localhost:{port}", 2, {pid})
        ids = np.random.default_rng(3).integers(0, 11, size=101)
        total = multihost_otu_psum(np.asarray(host_shard(list(ids))), 11)
        assert (total == np.bincount(ids, minlength=11)).all(), total
        print("PSUM_OK")
        """ for pid in (0, 1)]
    for r in run_procs(codes, timeout=120):
        assert r.returncode == 0 and "PSUM_OK" in r.stdout, r.stderr


def test_assign_fails_when_group_does_not_form(db_prefix, reads_fa,  # noqa: F811
                                               tmp_path, caplog,
                                               monkeypatch):
    """A process that cannot join its group stops with rc 1 and writes
    nothing, where the reference CLI carries on alone and process 0
    writes only its own shard of the rows."""
    import torch.distributed as dist
    from hmmufotu_tpu_torch.cli.assign import main

    def refuse(*args, **kwargs):
        raise RuntimeError("connection refused")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    out = tmp_path / "out.tsv"
    assert main([db_prefix, reads_fa, "-o", str(out), "--coordinator",
                 "localhost:1", "--num-processes", "2", "--process-id",
                 "0"], device="cpu") == 1
    assert errors(caplog) == ["could not join the 2-process group at "
                              "localhost:1"]
    assert not out.exists()


# ---------------------------------------------------------------------------
# the kernel build across processes
# ---------------------------------------------------------------------------

FAKE_NVCC = """#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open(os.path.join(os.path.dirname(out), "calls.log"), "a") as f:
    f.write(os.path.basename(sys.argv[-1]) + "\\n")
with open(out, "wb") as f:          # written in two halves
    f.write(b"half")
    f.flush()
    time.sleep(0.3)
    f.write(b" whole")
"""


def test_kernel_build_is_atomic_across_processes(tmp_path):
    """Three processes build on an empty build directory at once, with
    an nvcc that writes its output slowly: each library is compiled once,
    every process finds it whole, and no temporary file is left."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("viterbi", "place"):
        (csrc / f"{name}.cu").write_text("// source\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    code = f"""
        from hmmufotu_tpu_torch import _cuda
        _cuda.CSRC, _cuda.BUILD_DIR = {str(csrc)!r}, {str(build)!r}
        _cuda.nvcc_path = lambda: {str(nvcc)!r}
        _cuda.build_all()
        for name in _cuda.KERNEL_SOURCES:
            assert open(_cuda._lib_path(name), "rb").read() == b"half whole"
        print("BUILD_OK")
        """
    for r in run_procs([code] * 3, timeout=120):
        assert r.returncode == 0 and "BUILD_OK" in r.stdout, r.stderr
    calls = sorted((build / "calls.log").read_text().split())
    assert calls == ["place.cu", "viterbi.cu"]
    assert sorted(os.listdir(build)) == [".lock", "calls.log",
                                         "libplace.so", "libviterbi.so"]
