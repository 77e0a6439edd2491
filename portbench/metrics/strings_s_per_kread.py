"""strings_s_per_kread: Host seconds in ViterbiAligner.finalize_batch (the download and the alignment
strings) per 1,000 rows of the window."""

from portbench.probes import per_kread

LAYER = "Aligner, host"
UNIT = "s"
SOURCE = "program_span"
MOVES = "reads_per_s"
SPANS = [("hmmufotu_tpu_torch.hmm", "ViterbiAligner.finalize_batch", "strings")]


def read(run):
    return per_kread(run, "strings")
