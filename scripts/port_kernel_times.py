#!/usr/bin/env python3
"""Times of the port's Viterbi and SEP kernels on one GPU, of this checkout
and, beside it, of another.

    python3 scripts/port_kernel_times.py [--tree DIR]

Run from the repository root on a machine with one NVIDIA GPU.  Builds the
kernels and the 70_otus fixture DB, captures the kernels' inputs from one
main-path batch of 2,048 reads (as chip_smoke.py does), holds K1, K3 and K4
against their plain versions on them and times each K1 launch, K3 and K4.
The narrow K1 launch is also timed with the D chain cut short, which shows
what the chain costs (its results are then not the alignment's).  --tree DIR
then does the same, in a process of its own, for the port in DIR (say the
parent commit unpacked by `git archive` into a gitignored directory), so
that two versions are compared on one card in one call.  Prints the card's
name and power limit first.  Imports nothing of JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys


def arg(flag: str) -> str | None:
    return os.path.abspath(sys.argv[sys.argv.index(flag) + 1]) \
        if flag in sys.argv else None


# --root DIR: the checkout whose port and chip_smoke.py are timed
ROOT = arg("--root") or os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("port_kernel_times: needs one CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from hmmufotu_tpu_torch import _cuda
    from hmmufotu_tpu_torch.hmm import ViterbiAligner
    from hmmufotu_tpu_torch.hmm import cuda_viterbi as cv
    from hmmufotu_tpu_torch.phylo import cuda_place as cp
    cs.log(f"[tree] {ROOT}")
    cs.log(cs.card_line())
    for line in _cuda.build_all().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            cs.log("  " + line.strip())
    os.makedirs(cs.WORK, exist_ok=True)
    fx = os.path.join(cs.WORK, "70_otus")
    cs.build_fixture_db(fx)
    db = cs.load_db(fx)
    reads = cs.simulate_reads(db.ptu, np.random.default_rng(0), cs.BATCH)

    calls, patch = cs.capture_calls()
    with patch:
        cs.run_assign(db, reads, "cuda", len(reads))
        n_main = len(calls["viterbi"])
        ViterbiAligner(db.hmm, device="cuda").dispatch_batch(reads[:256],
                                                             None)
        torch.cuda.synchronize()
    v, sep = calls["viterbi"], calls["sep"][0]
    cs.check_k1(v[:n_main], "main batch")
    cs.check_k1(v[n_main:], "wide, full DP")
    r3 = cs.check_k3(sep, "dGamma4")
    r4 = cs.check_k4(db, reads)
    for call in v:
        ms = cs.cuda_ms(lambda: cv.viterbi_traced_cuda(*call), 5)
        cs.log(f"[times] K1 B={call[3].shape[0]} KP={call[8]} dchain="
               f"{call[11]}: {ms:.3f} ms")
    for dchain in (1, 32, 64, 128):
        cut = v[0][:11] + (dchain,)
        ms = cs.cuda_ms(lambda: cv.viterbi_traced_cuda(*cut), 5)
        cs.log(f"[times] K1 B={cut[3].shape[0]} KP={cut[8]} with the D "
               f"chain cut at {dchain} lanes: {ms:.3f} ms")
    cs.log(f"[times] K3 {r3['ms']:.3f} ms; K4 {r4['ms']:.3f} ms")
    got, plain = cp.sep_cuda(*sep), cp.sep_plain(*sep)
    lv = sep[7].reshape(-1)
    cs.log("[times] K3 lanes with the plain version's outer trips "
           f"{float((got[4][lv] == plain[4][lv]).float().mean()):.4f}, "
           f"inner trips "
           f"{float((got[5][lv] == plain[5][lv]).float().mean()):.4f}")
    tree = arg("--tree")
    if tree:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", tree],
            capture_output=True, text=True, cwd=tree)
        for line in res.stdout.splitlines():
            if line.startswith(("[times]", "[tree]")):
                cs.log("  other tree: " + line)
        if res.returncode != 0:
            cs.log(res.stderr[-2000:])
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
