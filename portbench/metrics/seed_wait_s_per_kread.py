"""seed_wait_s_per_kread: Seconds the stream's main thread waits for the seed-search worker (the
program's span wait_seed around the worker's future) per 1,000 rows of the window."""

from portbench import progtrace

LAYER = "Seed search"
UNIT = "s"
SOURCE = "program_span"
MOVES = "reads_per_s"


def install(patches, store):
    progtrace.install(patches, store)


def read(run):
    return progtrace.per_kread(run, "wait_seed")
