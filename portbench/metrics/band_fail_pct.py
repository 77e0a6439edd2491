"""band_fail_pct: Rows whose banded DP found no path and were run again at full width, in % of
the rows aligned (the program's counters band_fail and aln_reads)."""

from portbench import progtrace

LAYER = "Aligner, host"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "reads_per_s"


def install(patches, store):
    progtrace.install(patches, store)


def read(run):
    return progtrace.counter_pct(run, "band_fail", "aln_reads")
