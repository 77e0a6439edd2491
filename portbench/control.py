"""The readings a cell's limits are set from: sound runs, the control
and planted faults, on several seeds after one set-up.

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --runs sound:<seed>,<seed> control:<seed> seed_shift:<seed> ...
    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seed <n> [--mode control]

Each run makes its seed's read pool, warms up and serves a window of
--seconds as the benchmark's run does; once every window has closed the
program's state is freed and each window's rows are judged.  Modes:

- sound: the program as the configuration states it;
- control: a precision below the one the configuration states: the
  program's own bf16 message storage (assign --msg-bf16) for its f32,
  and the rows' alignments replaced by the reference's own with its DP
  in bf16 before they are judged;
- seed_shift: a fault planted in the program: every seed hit the seed
  search hands the aligner is moved SEED_SHIFT profile positions on, so
  the banded DP returns a valid path of the read, around the wrong
  columns;
- second_best: a fault put in the program's place: a sound window's rows
  judged with each placement replaced by the reference's second-best
  candidate (reference/judge.py).

Prints one result line a run, with "mode" and "seed", the numbers
compared beside the cell's limits last.  The benchmark's own runs never
run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("sound", "control", "seed_shift", "second_best")
SEED_SHIFT = 40


def shifted(fn):
    """batch_find_seed_vpaths with every hit moved SEED_SHIFT profile
    positions on, where the profile holds it."""
    @functools.wraps(fn)
    def run(hmm, *a, **kw):
        out = fn(hmm, *a, **kw)
        for vps in out:
            for vp in vps:
                if vp.end + SEED_SHIFT <= hmm.K:
                    vp.start += SEED_SHIFT
                    vp.end += SEED_SHIFT
        return out
    return run


def parse_runs(items) -> list[tuple[str, int]]:
    runs = []
    for item in items:
        mode, _, seeds = item.partition(":")
        if mode not in MODES or not seeds:
            raise SystemExit(f"--runs takes <mode>:<seed>[,<seed>...] with "
                             f"a mode of {', '.join(MODES)}: {item!r}")
        runs += [(mode, int(s)) for s in seeds.split(",")]
    return runs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--runs", nargs="*", default=[])
    p.add_argument("--seed", type=int)
    p.add_argument("--mode", default="control", choices=MODES)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    runs = parse_runs(args.runs)
    if args.seed is not None:
        runs.append((args.mode, args.seed))
    if not runs:
        raise SystemExit("no runs: give --runs or --seed")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    sys.path.insert(0, ROOT)
    from portbench import harness, probes
    from hmmufotu_tpu_torch import pipeline

    prog = harness.Program(ROOT, args.workload, args.device, T_START)

    def window_of(mode, seed):
        return ("sound", seed) if mode == "second_best" else (mode, seed)

    wins = {}
    for phase in ("f32", "bf16"):
        todo = [window_of(m, s) for m, s in runs
                if (m == "control") == (phase == "bf16")]
        if phase == "bf16" and todo:
            prog.make_placer(True)
        for key in todo:
            if key in wins:
                continue
            patches = probes.Patches()
            if key[0] == "seed_shift":
                patches.set(pipeline, "batch_find_seed_vpaths",
                            shifted(pipeline.batch_find_seed_vpaths))
            try:
                harness.log(f"{key[0]} window, seed {key[1]}")
                wins[key] = harness.Window(prog, key[1], args.seconds)
            finally:
                patches.undo()
    cache, traffic, checks, paired, dev = (prog.cache, prog.traffic,
                                           prog.checks, prog.paired, prog.dev)
    prog.free()
    for mode, seed in runs:
        w = wins[window_of(mode, seed)]
        t0 = time.perf_counter()
        nums = harness.check_rows(
            cache, traffic, w.lines, w.fwd, w.rev, seed, dev, paired,
            control=mode == "control",
            fault="second_best" if mode == "second_best" else None)
        harness.log(f"{mode} seed {seed}: {nums['rows_judged']} rows "
                    f"judged in {time.perf_counter() - t0:.1f} s")
        res = harness.verdict({"mode": mode, "seed": seed,
                               "attempted": w.rows, "failed": w.failed},
                              nums, checks)
        for k, c in res["checks"].items():
            print(f"{mode} {seed} {k} {c['value']!r} limit {c['limit']!r}",
                  file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
