"""aln_encode_s_per_kread: Seconds of the aligner's encode of a batch (codes and band regions, the
program's span encode, on the stream's worker thread) per 1,000 rows of the window."""

from portbench import progtrace

LAYER = "Aligner, host"
UNIT = "s"
SOURCE = "program_span"
MOVES = "reads_per_s"


def install(patches, store):
    progtrace.install(patches, store)


def read(run):
    return progtrace.per_kread(run, "encode")
