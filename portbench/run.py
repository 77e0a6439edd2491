"""Run one cell of the benchmark of hmmufotu_tpu_torch once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints the result as one JSON line, the
last line of standard output; the numbers compared with the reference,
each beside its limit, are the last lines of standard error.  Exits 2
without a result where the cell's CUDA cards are missing, 3 where JAX
or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "hmmufotu_tpu"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX,
    jaxlib, flax or the JAX package, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu: the tests' tiny runs; never a measurement")
    args = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    sys.path.insert(0, ROOT)
    from portbench import harness
    res = harness.run(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), args.device, T_START)
    bad = forbidden_modules()
    if bad:
        print(f"[portbench] loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
