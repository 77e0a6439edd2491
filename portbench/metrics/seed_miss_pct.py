"""seed_miss_pct: Reads with no valid seed path on either side, which get a full-width DP, in % of
the reads searched (the program's counters seed_miss and seed_reads)."""

from portbench import progtrace

LAYER = "Seed search"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "reads_per_s"


def install(patches, store):
    progtrace.install(patches, store)


def read(run):
    return progtrace.counter_pct(run, "seed_miss", "seed_reads")
