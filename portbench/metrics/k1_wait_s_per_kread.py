"""k1_wait_s_per_kread: Seconds the aligner's host side waits for the event recorded after K1's
launch (the program's span dp) per 1,000 rows of the window."""

from portbench import progtrace

LAYER = "Aligner, host"
UNIT = "s"
SOURCE = "program_span"
MOVES = "reads_per_s"


def install(patches, store):
    progtrace.install(patches, store)


def read(run):
    return progtrace.per_kread(run, "dp")
