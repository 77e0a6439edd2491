"""The placer's node blocks: the seed p-dist made one node block at a
time (placement.seed_pdist) and the message upload filled one node block
at a time (placement.upload_messages) give the bits of the whole
computation, so the whole tree of the gg_97 shape fits on one card
without changing an answer.  The reference package computes both whole;
tests/test_torch_place.py and tests/test_torch_db.py hold the port's
whole versions against it."""

import numpy as np
import pytest
import torch

from test_torch_pipeline import db_prefix, one_torch_thread  # noqa: F401


def bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("rows", [1, 7, 64, 299, 300, 1000])
def test_seed_pdist_node_blocks_bit_equal(monkeypatch, rows):
    """Blocks of `rows` nodes against one product over all nodes: the
    same bits, nan where no site overlaps included (counts above 256 in
    the mix)."""
    from hmmufotu_tpu_torch.phylo import placement
    rng = np.random.default_rng(rows)
    B, N, Ws = 12, 300, 1536
    seqs_w = torch.from_numpy(rng.integers(-2, 4, (B, Ws)).astype(np.int8))
    nseqs = rng.integers(-2, 4, (N, Ws)).astype(np.int8)
    nseqs[5] = -2                      # a node with no valid site
    starts = rng.integers(0, Ws // 4, B)
    ends = starts + rng.integers(100, 3 * Ws // 4, B)
    site = np.arange(Ws)[None, :]
    q_valid = torch.from_numpy((seqs_w.numpy() >= 0)
                               & (site >= starts[:, None])
                               & (site <= ends[:, None]))
    n1h = torch.from_numpy((nseqs[:, :, None] == np.arange(4, dtype=np.int8))
                           .reshape(N, Ws * 4)).to(torch.bfloat16)
    nv = torch.from_numpy(nseqs >= 0).to(torch.bfloat16)
    seen = []

    def planes(n0, n1):
        seen.append((n0, n1))
        return n1h[n0:n1], nv[n0:n1]

    monkeypatch.setattr(placement, "PDIST_CHUNK_BYTES",
                        rows * placement.PDIST_BYTES_PER_COL * Ws)
    got = placement.seed_pdist(seqs_w, q_valid, planes, N)
    want = placement.seed_pdist_bf16(seqs_w, q_valid, n1h, nv)
    assert got.shape == (B, N) and got.dtype == torch.float32
    np.testing.assert_array_equal(bits(got), bits(want))
    assert np.isnan(got[:, 5].numpy()).all()
    step = min(rows, N)
    assert seen == [(n0, min(n0 + step, N)) for n0 in range(0, N, step)]


def leaf_reads(tree, n, seed, start_max, span=300):
    """[n, csLen] digital reads: leaf rows inside a window of `span`
    columns starting before start_max, with 2% substitutions, and their
    0-based windows."""
    rng = np.random.default_rng(seed)
    leaves = np.nonzero(tree.has_seq & (tree.msa_id >= 0))[0]
    seqs = np.full((n, tree.cs_len), -2, np.int8)
    starts = rng.integers(0, start_max, n)
    for r, st in enumerate(starts):
        row = tree.seqs[int(rng.choice(leaves)), st:st + span].copy()
        mut = (rng.random(span) < 0.02) & (row >= 0)
        row[mut] = rng.integers(0, 4, int(mut.sum()))
        seqs[r, st:st + span] = row
    return seqs, starts, starts + span - 1


@pytest.mark.parametrize("site_window", [None, (0, 1024)],
                         ids=["whole_tree", "window"])
def test_placement_node_blocks_bit_equal(db_prefix, monkeypatch,  # noqa
                                         site_window):
    """A batch placed with the p-dist in blocks of 16 to 24 nodes (by the
    union window's width): every output of place_batch bit-equal to one
    product over the tree's 249 nodes."""
    from hmmufotu_tpu_torch.db import Database
    from hmmufotu_tpu_torch.phylo import placement
    tree = Database.load(db_prefix).ptu
    placer = placement.DevicePlacer(tree, device="cpu",
                                    site_window=site_window)
    hi = tree.cs_len if site_window is None else sum(site_window)
    seqs, starts, ends = leaf_reads(tree, 24, 3, hi - 300)
    whole = placer.place_batch(seqs, starts, ends)
    blocks = []
    planes_of = placement.seed_pdist_bf16

    def per_block(seqs_w, q_valid, n1h8, nv8):
        blocks.append(len(nv8))
        return planes_of(seqs_w, q_valid, n1h8, nv8)

    monkeypatch.setattr(placement, "seed_pdist_bf16", per_block)
    monkeypatch.setattr(placement, "PDIST_CHUNK_BYTES",
                        16 * placement.PDIST_BYTES_PER_COL * 1536)
    got = placer.place_batch(seqs, starts, ends)
    assert sum(blocks) == tree.num_nodes and len(blocks) >= 249 // 24
    assert len(set(blocks[:-1])) == 1
    assert set(got) == set(whole)
    for k, v in whole.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert (whole["summary"][:, 11] > 0).all()


@pytest.mark.parametrize("msg_dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("site_window", [None, (200, 1024)],
                         ids=["whole_tree", "window"])
def test_upload_node_blocks_equal_one_conversion(db_prefix, monkeypatch,  # noqa
                                                 msg_dtype, site_window):
    """DeviceTree.from_tree fills the message tensors in node blocks from
    the host's messages (f32 as a loaded DB holds them, or f64 as an f64
    evaluate leaves them): in blocks of 5 nodes each equals the one whole
    -> f32 -> storage-dtype conversion of the window, and every field
    equals that of the default block size."""
    from hmmufotu_tpu_torch.db import Database
    from hmmufotu_tpu_torch.phylo import placement
    tree = Database.load(db_prefix).ptu
    assert tree.msg_up.dtype == np.float32
    lo, hi = (0, tree.cs_len) if site_window is None \
        else (site_window[0], sum(site_window))
    want_dtype = msg_dtype or torch.float32
    a = placement.DeviceTree.from_tree(tree, "cpu", msg_dtype, site_window)
    monkeypatch.setattr(placement, "UPLOAD_CHUNK_BYTES",
                        5 * 4 * 4 * (hi - lo))
    # f64 messages that f32 does not hold exactly
    for msg in (tree.msg_up, tree.msg_down,
                np.float64(tree.msg_down) * (1 + 1e-9)):
        got = placement.upload_messages(msg[:, :, lo:hi], "cpu", want_dtype)
        want = torch.as_tensor(np.asarray(msg[:, :, lo:hi], np.float32)
                               ).to(want_dtype)
        assert got.dtype == want_dtype and got.shape == want.shape
        assert torch.equal(got, want)
    b = placement.DeviceTree.from_tree(tree, "cpu", msg_dtype, site_window)
    for k in placement.DeviceTree._fields:
        x, y = getattr(a, k), getattr(b, k)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert x == y, k
    assert a.msg_up.shape == (tree.num_nodes, 4, hi - lo)


def test_upload_reads_the_host_array_block_by_block(monkeypatch):
    """The host staging of an upload is one node block: the [N, 4, L] f64
    array is read (and rounded to f32) one block of rows at a time, never
    whole."""
    from hmmufotu_tpu_torch.phylo import placement
    msg = np.random.default_rng(0).standard_normal((50, 4, 64))

    class Recorded:
        shape = msg.shape
        seen = []

        def __len__(self):
            return len(msg)

        def __getitem__(self, key):
            self.seen.append((key.start, key.stop))
            return msg[key]

    rec = Recorded()
    monkeypatch.setattr(placement, "UPLOAD_CHUNK_BYTES", 8 * 4 * 4 * 64)
    got = placement.upload_messages(rec, "cpu", torch.float32)
    assert rec.seen == [(n0, n0 + 8) for n0 in range(0, 50, 8)]
    assert torch.equal(got, torch.from_numpy(msg.astype(np.float32)))
