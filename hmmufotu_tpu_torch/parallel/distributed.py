"""Multi-process execution helpers, on torch.distributed.

Counterpart of hmmufotu_tpu/parallel/distributed.py.  Used by
`assign --num-processes N --process-id I --coordinator H:P`
(cli/assign.py): each process aligns and places its contiguous read
shard, then the TSV rows are gathered to process 0 in process order,
which reproduces the single-process output rows byte for byte (the
FM-index occurrence pick is deterministic without -S).

The process group is gloo.  Both collectives here take and return host
data (text and count vectors), and each process drives the cards of its
own host (cli/assign.py builds its mesh per process), so no device
tensor crosses processes.  gloo also runs two ranks on one card, which
NCCL refuses, and the same code in the CPU tests.
"""

from __future__ import annotations

import atexit
import logging

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """Join the process group (a no-op for one process) and return the
    number of processes in it.

    `coordinator` is the host:port of process 0's rendezvous.  On a
    failure to connect the process logs a warning and carries on alone,
    as the reference package does; the caller sees a count of 1."""
    if num_processes == 1:
        return 1
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id)
        log.info("distributed: process %d/%d", dist.get_rank(),
                 dist.get_world_size())
        # a gloo group still alive when the interpreter finalizes can
        # abort the process as it ends ("terminate called without an
        # active exception"), after its work is done
        atexit.register(_leave)
    except (RuntimeError, ValueError) as e:
        log.warning("torch.distributed init failed (%s); "
                    "continuing single-process", e)
    return _rank_world()[1]


def _leave() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_bounds(n_items: int, process_id: int | None = None,
                num_processes: int | None = None) -> tuple[int, int]:
    """[lo, hi) bounds of this process's contiguous slice of a global
    work list."""
    rank, world = _rank_world()
    pid = rank if process_id is None else process_id
    n = world if num_processes is None else num_processes
    per = (n_items + n - 1) // n
    return pid * per, min((pid + 1) * per, n_items)


def host_shard(items: list, process_id: int | None = None,
               num_processes: int | None = None) -> list:
    """This process's contiguous slice of a global work list (reads or
    sample files)."""
    lo, hi = host_bounds(len(items), process_id, num_processes)
    return items[lo:hi]


def _all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    """Every process's `t`, in rank order ([t] without a group)."""
    if _rank_world()[1] == 1:
        return [t]
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return out


def gather_host_text(text: str,
                     chunk_bytes: int = 64 << 20) -> list[str]:
    """Gather one text blob per process to process 0 in process order.
    Every process calls this; process 0 gets the texts, the others [].

    Chunked: each round all-gathers one chunk of every process, so the
    peak memory is bounded by the chunk size, not by the largest
    process's output.  Lengths go first, then rounds of
    min(chunk_bytes, longest) bytes."""
    blob = text.encode()
    lens = torch.cat(_all_gather(
        torch.tensor([len(blob)], dtype=torch.int64))).tolist()
    n_proc = len(lens)
    longest = max(lens)
    chunk_bytes = min(chunk_bytes, max(longest, 1))
    rounds = max(1, -(-longest // chunk_bytes))
    is_zero = _rank_world()[0] == 0
    parts = [bytearray() for _ in range(n_proc)] if is_zero else None
    buf = np.zeros(chunk_bytes, np.uint8)
    for r in range(rounds):
        lo = r * chunk_bytes
        piece = blob[lo:lo + chunk_bytes]
        buf[:len(piece)] = np.frombuffer(piece, np.uint8)
        buf[len(piece):] = 0
        gathered = _all_gather(torch.from_numpy(buf))
        if is_zero:
            for p in range(n_proc):
                n = min(max(lens[p] - lo, 0), chunk_bytes)
                if n:
                    parts[p] += gathered[p][:n].numpy().tobytes()
        del gathered
    if not is_zero:
        return []
    return [bytes(p).decode() for p in parts]


def multihost_otu_psum(local_taxon_ids: np.ndarray,
                       n_taxa: int) -> np.ndarray:
    """Global per-taxon OTU count vector: each process counts its own
    taxon ids and an all-reduce sums the counts over the processes (the
    distributed form of OTUTable operator+=, reference
    OTUTable.cpp:211-240).  Every process calls this and gets the same
    vector (numpy)."""
    counts = torch.from_numpy(np.bincount(
        np.asarray(local_taxon_ids, np.int64), minlength=n_taxa))
    if _rank_world()[1] > 1:
        dist.all_reduce(counts, op=dist.ReduceOp.SUM)
    return counts.numpy().astype(np.int32)
