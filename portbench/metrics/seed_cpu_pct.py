"""seed_cpu_pct: The seed-search thread's CPU time over the wall time of the program's span seed,
in %: under 100 where the thread waits, for the interpreter lock among others."""

from portbench import progtrace

LAYER = "Seed search"
UNIT = "%"
SOURCE = "program_span"
MOVES = "reads_per_s"


def install(patches, store):
    progtrace.install(patches, store)


def read(run):
    recs = progtrace.records(run, "seed")
    wall = sum(r.end_ns - r.start_ns for r in recs or ())
    if not wall:
        return None
    return 100.0 * sum(r.cpu_ns for r in recs) / wall
