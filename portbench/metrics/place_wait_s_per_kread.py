"""place_wait_s_per_kread: Seconds of the placement summary's download, which waits for the placer
(the program's span place_wait), per 1,000 rows of the window."""

from portbench import progtrace

LAYER = "Placement, host side"
UNIT = "s"
SOURCE = "program_span"
MOVES = "reads_per_s"


def install(patches, store):
    progtrace.install(patches, store)


def read(run):
    return progtrace.per_kread(run, "place_wait")
