"""Old against new for the port's DB files, on one host: the npz reader
and writer of hmmufotu_tpu_torch/io/npz.py against the one zlib thread
they replace.  Steps:

  1. load   the .ptu.npz of --db PREFIX read whole four times: np.load
            (one zlib stream a member on one thread: the reference
            package's load, and the port's before), the port's NpzReader
            on every core, NpzReader again, np.load again.  Each read is
            cold: the file's pages are dropped from the page cache first
            (posix_fadvise DONTNEED).  Seconds and GB/s of each; the
            sha256 of every member after each read (outside the clock),
            which must agree across the four;
  2. save   the first --writer-nodes rows of every node-indexed member of
            that file (its real messages: a smaller tree's worth), written
            by write_npz on 1 thread (what the old sequential save did:
            the same level and chunks), on every core, every core again,
            1 thread again; the files' bytes must agree; then that file
            read back by NpzReader on 1 thread and on every core;
  3. one JSON line, the last the script prints: every number, the card
            line, the host's cores and `free -g`'s total; --out FILE gets
            it too.  Exits 1 when a digest or a file's bytes disagree.

    python scripts/torch_npz_times.py --db .bench/torch_scale_sum/db \\
        --writer-nodes 10000 --out out/npz_times.json
CPU smoke: add --device cpu (no card line) on a small DB.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, SCRIPTS)

from torch_scale_cli import free_total_gb, log  # noqa: E402
from torch_scale_eval import card_line  # noqa: E402

from hmmufotu_tpu_torch.io.npz import (NpzReader, host_threads,  # noqa
                                       write_npz)


def drop_cache(path: str):
    """Write the file's dirty pages back, then drop its pages from the
    page cache."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def digest(arr: np.ndarray) -> str:
    data = arr.T if arr.flags.f_contiguous and not arr.flags.c_contiguous \
        else np.ascontiguousarray(arr)
    return hashlib.sha256(memoryview(data.reshape(-1).view(np.uint8))
                          ).hexdigest()


def read_whole(path: str, how: str, threads: int | None = None):
    """(seconds, arrays) of one cold read of every member."""
    drop_cache(path)
    t = time.perf_counter()
    if how == "np.load":
        with np.load(path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
    else:
        with NpzReader(path, threads) as z:
            arrays = {k: z[k] for k in z.files}
    return time.perf_counter() - t, arrays


def timed_reads(path: str, order, threads=None,
                take=None) -> tuple[list, bool]:
    """Each read of `order` (np.load or port) with its seconds, GB/s of
    the arrays' bytes and of the file's, and whether every read gave the
    same member digests; take(arrays) sees the arrays of each read."""
    runs, digests = [], []
    size = os.path.getsize(path)
    for how in order:
        secs, arrays = read_whole(path, how, threads)
        n = sum(a.nbytes for a in arrays.values())
        digests.append({k: digest(a) for k, a in arrays.items()})
        if take:
            take(arrays)
        del arrays
        runs.append({"reader": how, "s": secs, "array_bytes": n,
                     "file_bytes": size, "array_gb_per_s": n / secs / 1e9,
                     "file_gb_per_s": size / secs / 1e9})
        log(f"read {how}: {json.dumps(runs[-1])}")
    return runs, all(d == digests[0] for d in digests)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--db", required=True, help="DB prefix (its .ptu.npz)")
    ap.add_argument("--writer-nodes", type=int, default=10000,
                    help="the rows of each node-indexed member written")
    ap.add_argument("--out", default="", help="JSON file of the result")
    ap.add_argument("--device", default="cuda",
                    help="the card named beside the numbers; cpu names none")
    args = ap.parse_args(argv)
    path = args.db + ".ptu.npz"
    threads = host_threads()
    res = {"card": card_line(args.device), "host_threads": threads,
           "cpu_count": os.cpu_count(), "free_total_gb": free_total_gb(),
           "file": path, "file_bytes": os.path.getsize(path)}

    # ---- 1. the whole file: np.load against the port's reader ----------
    small = {}

    def take(arrays):
        # the first --writer-nodes rows of each node-indexed member, copied
        if not small:
            n_nodes = len(arrays["parent"])
            small.update({k: np.array(a[:args.writer_nodes])
                          if a.ndim and len(a) == n_nodes else a
                          for k, a in arrays.items()})

    res["load"], res["load_digests_equal"] = timed_reads(
        path, ("np.load", "port", "port", "np.load"), take=take)

    # ---- 2. the writer on 1 thread against every core -------------------
    N = len(small["parent"])
    d = os.path.dirname(os.path.abspath(path))
    files, saves = [], []
    for k, th in enumerate((1, threads, threads, 1)):
        out = os.path.join(d, f"npz_times_{k}.npz")
        t = time.perf_counter()
        write_npz(out, small, threads=th)
        secs = time.perf_counter() - t
        with open(out, "rb") as fh:
            files.append(hashlib.file_digest(fh, "sha256").hexdigest())
        n = sum(a.nbytes for a in small.values())
        saves.append({"threads": th, "s": secs, "array_bytes": n,
                      "file_bytes": os.path.getsize(out),
                      "array_gb_per_s": n / secs / 1e9})
        log(f"save on {th} threads: {json.dumps(saves[-1])}")
        if k:
            os.unlink(out)
    del small
    res.update(save_nodes=N, save=saves,
               save_bytes_equal=all(f == files[0] for f in files))
    small_path = os.path.join(d, "npz_times_0.npz")
    res["reread"] = []
    for th in (1, threads):
        runs, _ = timed_reads(small_path, ("port",), th)
        runs[0]["threads"] = th
        res["reread"] += runs
    os.unlink(small_path)
    ok = res["load_digests_equal"] and res["save_bytes_equal"]
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
