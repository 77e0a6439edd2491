"""Sharding of the assignment pipeline over a list of devices.

Counterpart of hmmufotu_tpu/parallel/sharding.py.  The reference package
shard_maps one program over a jax Mesh; here a Mesh is a tuple of torch
devices and each shard's work is launched from a host loop over it:

  * the DB tensors (HMM costs, node sequences, message tensors) are
    replicated on each device (sharded_place_batch), or the message
    tensors are split in node blocks (sharded_place_batch_tree);
  * the read batch is split in contiguous blocks, one a shard, and the
    results are concatenated in shard order;
  * per-taxon OTU counts are summed onto the first shard's device (the
    reference package's psum over the data axis).

A device may appear more than once: four shards on one card run the
sharded code paths at their real shapes where there is one card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .._cuda import resolve_device
from ..hmm.viterbi import DeviceHMM, viterbi_scan

DATA_AXIS = "data"
MODEL_AXIS = "model"
CPU_SHARDS = 8      # the reference tests' virtual CPU devices


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices of its shards, in shard order."""
    devices: tuple[torch.device, ...]
    axis_name: str = DATA_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, local: bool = False,
              device="cuda") -> Mesh:
    """1-D data mesh.  device="cuda": the cards cuda:0..cuda:k-1 of this
    host, cut to n_devices (raises without a card).  device="cpu":
    n_devices CPU shards, default 8.  `local` is accepted for the
    reference's signature: a torch process sees only its own host's
    cards."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        n = CPU_SHARDS if n_devices is None else n_devices
        return Mesh((dev,) * n)
    devs = tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs)


def _blocks(n_items: int, mesh: Mesh):
    """[(device, lo, hi)] of each shard's contiguous block of items."""
    per = -(-n_items // mesh.size)
    return [(d, i * per, min((i + 1) * per, n_items))
            for i, d in enumerate(mesh.devices)]


def _on(x, dev, dtype=None) -> torch.Tensor:
    """Array or tensor `x` as a tensor on `dev`."""
    return torch.as_tensor(x, dtype=dtype).to(dev)


def sharded_assign_step(mesh: Mesh, dh: DeviceHMM, node_seqs, anno_of_node,
                        n_taxa: int, codes, lengths, regions, n_rows: int):
    """One data-parallel assignment step over the mesh.

    Per shard: the banded Viterbi (viterbi_scan) over its reads, then a
    seed-style p-dist argmin over all tree nodes (the masked mismatch
    count of getSeed, reference HmmUFOtu_main.cpp:127-152) as the
    taxonomy vote, and a per-taxon count vector summed over the shards.

    Returns (scores [B] f32, best_node [B] int64, taxon_counts [n_taxa]
    int32), on the first shard's device."""
    scores, best, counts = [], [], []
    for dev, lo, hi in _blocks(len(codes), mesh):
        if lo >= hi:
            continue
        dh_l = DeviceHMM(*(x.to(dev) for x in dh))
        codes_l = _on(codes[lo:hi], dev)
        lengths_l = _on(lengths[lo:hi], dev)
        s, _, _, _ = viterbi_scan(dh_l, codes_l, lengths_l,
                                  _on(regions[lo:hi], dev), n_rows)
        ns = _on(node_seqs, dev)
        read_valid = (torch.arange(codes_l.shape[1], device=dev)[None, :]
                      < lengths_l[:, None])
        q = torch.where(read_valid, codes_l, -1)
        both = (q[:, None, :] >= 0) & (ns[None, :, :] >= 0)
        mis = ((q[:, None, :] != ns[None, :, :]) & both).sum(-1)
        inf_sites = both.sum(-1)
        dist = mis / torch.clamp(inf_sites, min=1)
        b = torch.argmin(torch.where(inf_sites > 0, dist, math.inf), dim=1)
        taxa = _on(anno_of_node, dev, torch.int64)[b]
        scores.append(s)
        best.append(b)
        counts.append(torch.bincount(taxa, minlength=n_taxa))
    first = mesh.devices[0]
    return (torch.cat([s.to(first) for s in scores]),
            torch.cat([b.to(first) for b in best]),
            sum(c.to(first) for c in counts).to(torch.int32))


def sharded_otu_accumulate(mesh: Mesh, taxon_ids, n_taxa: int
                           ) -> torch.Tensor:
    """Per-taxon count vector of sharded per-read taxon ids, summed over
    the shards (the collective form of OTU-table merging, reference
    hmmufotu-sum.cpp:388-397 / OTUTable operator+=).  int32, on the
    first shard's device."""
    first = mesh.devices[0]
    total = torch.zeros(n_taxa, dtype=torch.int64, device=first)
    for dev, lo, hi in _blocks(len(taxon_ids), mesh):
        ids = _on(taxon_ids[lo:hi], dev, torch.int64)
        total += torch.bincount(ids, minlength=n_taxa).to(first)
    return total.to(torch.int32)


def sharded_place_batch(mesh: Mesh, placer, seqs, starts, ends,
                        max_diff=math.inf, max_height=math.inf,
                        max_error=20.0, height_prior=False,
                        ml_only=False) -> np.ndarray:
    """Data-parallel SEP placement over the mesh: reads split in
    contiguous blocks, the DeviceTree replicated on each device
    (DevicePlacer.on_device, built once).  Every shard places with the
    union site window of the whole batch.

    `seqs`: full [B, csLen] digital reads or [B, W] windows.  As in the
    reference package, the placer's opt_k, ref_rank and est_kernel
    settings are not applied here (place_batch_device's defaults).
    Returns the [B, 12] best-placement summary (numpy)."""
    from ..phylo.placement import place_batch_device
    seqs = placer.windows(seqs, starts)
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    s0, Ws = placer.union_window(starts)
    outs = []
    for dev, lo, hi in _blocks(len(seqs), mesh):
        if lo >= hi:
            continue
        dt, eig = placer.on_device(dev)
        out = place_batch_device(
            dt, _on(seqs[lo:hi], dev), _on(starts[lo:hi], dev),
            _on(ends[lo:hi], dev), max_diff, max_height, max_error,
            placer.W, placer.C, placer.n_rates, placer.tree.cs_len, eig,
            height_prior, ml_only, s0=s0, Ws=Ws,
            sep_kernel=placer.sep_kernel, fp_kernel=placer.fp_kernel)
        outs.append(out["summary"])
    return torch.cat([o.cpu() for o in outs]).numpy()


TREE_GRIDS = ("cand", "c_dist", "est_loglik", "loglik", "ratio", "wnr",
              "w0", "live")


def tree_shards(mesh: Mesh, placer) -> list:
    """[(node_lo, DeviceTree, eig)] of each shard: the message tensors
    padded to Nl * n nodes and cut in node blocks of Nl, each block with
    the whole per-node metadata on its shard's device (only the block of
    the messages moves there).  Built once per mesh and kept on the
    placer."""
    from ..phylo.placement import moved
    if mesh.devices not in placer._tree_shards:
        dt = placer.dt
        N = dt.msg_up.shape[0]
        Nl = -(-N // mesh.size)
        shards = []
        for i, dev in enumerate(mesh.devices):
            blocks = []
            for m in (dt.msg_up, dt.msg_down):
                b = m[i * Nl:(i + 1) * Nl]
                if b.shape[0] < Nl:
                    b = torch.cat([b, b.new_zeros((Nl - b.shape[0],)
                                                  + b.shape[1:])])
                blocks.append(b)
            dt_l = dt._replace(msg_up=blocks[0], msg_down=blocks[1])
            shards.append((i * Nl, moved(dt_l, dev),
                           moved(placer.eig, dev)))
        placer._tree_shards[mesh.devices] = shards
    return placer._tree_shards[mesh.devices]


def sharded_place_batch_tree(mesh: Mesh, placer, seqs, starts, ends,
                             max_diff=math.inf, max_height=math.inf,
                             max_error=20.0, height_prior=False,
                             ml_only=False) -> dict:
    """Tree-sharded SEP placement: the per-edge message tensors (the
    memory-dominant [N, 4, L] pair) split over the mesh in node blocks
    (tree_shards); reads and the small per-node metadata replicated.
    Each shard places the whole batch on candidates of its own node block
    (place_batch_device node_lo=, every candidate optimized) and returns
    its candidate grid; the grids concatenate over the candidate axis,
    shard-major, for the exact host merge (pipeline.merge_mp_candidates).

    Returns a dict of numpy grids [B, C * n_shards]: TREE_GRIDS, with
    cand and live as f32 (as the reference package returns them)."""
    from ..phylo.placement import place_batch_device
    seqs = placer.windows(seqs, starts)
    starts = np.asarray(starts, np.int64)
    ends = np.minimum(np.asarray(ends, np.int64), starts + placer.W - 1)
    s0, Ws = placer.union_window(starts)
    grids = {k: [] for k in TREE_GRIDS}
    for node_lo, dt_l, eig in tree_shards(mesh, placer):
        dev = dt_l.pi.device
        out = place_batch_device(
            dt_l, _on(seqs, dev), _on(starts, dev), _on(ends, dev),
            max_diff, max_height, max_error, placer.W, placer.C,
            placer.n_rates, placer.tree.cs_len, eig, height_prior,
            ml_only, opt_k=placer.C, s0=s0, Ws=Ws,
            sep_kernel=placer.sep_kernel, fp_kernel=placer.fp_kernel,
            node_lo=node_lo)
        for k in TREE_GRIDS:
            grids[k].append(out[k].to(dt_l.pi.dtype))
    return {k: torch.cat([g.cpu() for g in v], dim=1).numpy()
            for k, v in grids.items()}
