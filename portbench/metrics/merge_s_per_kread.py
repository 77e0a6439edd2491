"""merge_s_per_kread: Host seconds in HmmAlignment.merge (the mates' merge) per 1,000 rows of the
window; nothing to read where no mates are merged."""

from portbench.probes import per_kread

LAYER = "CLI rows and merge"
UNIT = "s"
SOURCE = "program_span"
MOVES = "reads_per_s"
SPANS = [("hmmufotu_tpu_torch.hmm", "HmmAlignment.merge", "merge")]


def read(run):
    return per_kread(run, "merge")
