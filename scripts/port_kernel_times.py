#!/usr/bin/env python3
"""Times of the port's kernels on one GPU, of this checkout and, beside it,
of another.

    python3 scripts/port_kernel_times.py [--tree DIR]

Run from the repository root on a machine with one NVIDIA GPU.  Builds the
kernels and the 70_otus fixture DB, captures the kernels' inputs from one
main-path batch of 2,048 reads and from the same batch through the
fixed-point placer (as chip_smoke.py does), holds K1 to K5 against their
plain versions on them and times each K1 launch, K2, K3, K4 and the K5 call
with the most lanes iterating.  The narrow K1 launch is also timed with the
D chain cut short, which shows what the chain costs (its results are then
not the alignment's); K5 also with only its slowest lane iterating (its
chain floor).  K2 and K5 are timed both as their wrappers' calls (device
time, the host's enqueue time hidden behind a spin kernel) and as the
kernels alone (the profiler's device time of the kernels named est_kernel,
fp_kernel and fp_list_kernel).  --tree DIR then does the same, in a process
of its own, for the port in DIR (say the parent commit unpacked by `git
archive` into a gitignored directory), so that two versions are compared
on one card in one call; both are timed by this script's functions.
Prints the card's name and power limit first.  Imports nothing of JAX.
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


def device_ms(fn, reps: int) -> float:
    """Device time of one call of fn: CUDA events around reps calls, with a
    spin kernel ahead so that the host's enqueue time stays out."""
    import torch
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000 * reps)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def kernel_ms(fn, names, reps: int) -> float:
    """Device time a call of fn spends in the kernels whose names contain
    one of `names` (a template's name starts with its return type), by the
    profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.device_time_total for ev in prof.key_averages()
             if any(name + "(" in ev.key or name + "<" in ev.key
                    for name in names))
    return us / 1e3 / reps


def sass_loops(lib: str, kernel: str):
    """(instructions, [loop body sizes]) of a kernel in a built library,
    from cuobjdump's SASS: the body of each backward branch up to 600
    instructions long."""
    import re
    import shutil
    from hmmufotu_tpu_torch import _cuda
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_cuda.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        if kernel not in func.split("\n")[0]:
            continue
        n = len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+[@A-Z]", func))
        loops = []
        branch = r"/\*([0-9a-f]{4,})\*/[^\n]*BRA[^\n]*?0x([0-9a-f]+)"
        for m in re.finditer(branch, func):
            src, dst = int(m.group(1), 16), int(m.group(2), 16)
            if dst < src and (src - dst) // 16 + 1 <= 600:
                loops.append((src - dst) // 16 + 1)
        return n, loops
    return 0, []


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
    lib = os.path.join(_cuda.BUILD_DIR, "libplace.so")
    # K5 at a 512-site window is fp_kernel<4> (mangled fp_kernelILi4E)
    for name, kernel in (("est_kernel", "est_kernel"),
                         ("fp_kernel<4>", "fp_kernelILi4E")):
        n, loops = sass_loops(lib, kernel)
        cs.log(f"[sass] {name}: {n} instructions, loop bodies {loops}")
    os.makedirs(cs.WORK, exist_ok=True)
    fx = os.path.join(cs.WORK, "70_otus")
    cs.build_fixture_db(fx)
    db = cs.load_db(fx)
    reads = cs.simulate_reads(db.ptu, np.random.default_rng(0), cs.BATCH)

    from hmmufotu_tpu_torch.phylo import cuda_fixed_point as cf
    calls, patch = cs.capture_calls()
    with patch:
        cs.run_assign(db, reads, "cuda", len(reads))
        n_main = len(calls["viterbi"])
        ViterbiAligner(db.hmm, device="cuda").dispatch_batch(reads[:256],
                                                             None)
        cs.run_assign(db, reads, "cuda", len(reads),
                      placer_kw=dict(sep_kernel=False, fp_kernel=True))
        torch.cuda.synchronize()
    v, sep = calls["viterbi"], calls["sep"][0]
    est, fp = calls["est"][0], calls["fp"][0][1]
    cs.check_k1(v[:n_main], "main batch")
    cs.check_k1(v[n_main:], "wide, full DP")
    cs.check_k2(est)
    cs.check_k3(sep, "dGamma4")
    r4 = cs.check_k4(db, reads)
    cs.check_k5(fp)
    for call in v:
        ms = device_ms(lambda: cv.viterbi_traced_cuda(*call), 5)
        cs.log(f"[times] K1 B={call[3].shape[0]} KP={call[8]} dchain="
               f"{call[11]}: {ms:.3f} ms")
    for dchain in (1, 32, 64, 128):
        cut = v[0][:11] + (dchain,)
        ms = device_ms(lambda: cv.viterbi_traced_cuda(*cut), 5)
        cs.log(f"[times] K1 B={cut[3].shape[0]} KP={cut[8]} with the D "
               f"chain cut at {dchain} lanes: {ms:.3f} ms")
    k3 = device_ms(lambda: cp.sep_cuda(*sep), 5)
    cs.log(f"[times] K3 {k3:.3f} ms; K4 {r4['ms']:.3f} ms")
    for _ in range(2):
        cs.log(f"[times] K2 fixture batch: call "
               f"{device_ms(lambda: cp.est_cuda(*est), 20):.4f} ms, kernel "
               f"{kernel_ms(lambda: cp.est_cuda(*est), ['est_kernel'], 10):.4f}"
               " ms")
    eA, eB, n, p_init, skip = fp
    trips = cs.fp_trips(eA, eB, n.to(torch.float32), p_init, skip)
    alone = torch.ones_like(skip)
    alone[int(torch.argmax(trips))] = False
    for label, sk in (("K5 most-iterating call", skip),
                      ("K5 chain floor, slowest lane alone", alone)):
        for _ in range(2):
            call = (eA, eB, n, p_init, sk)
            ms = device_ms(lambda: cf.fixed_point_cuda(*call), 50)
            kms = kernel_ms(lambda: cf.fixed_point_cuda(*call),
                            ["fp_kernel", "fp_list_kernel"], 20)
            cs.log(f"[times] {label} ({int((~sk).sum())} lanes iterating, "
                   f"max trips {int(trips[~sk].max())}): call {ms:.4f} ms, "
                   f"kernel {kms:.4f} ms")
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
