"""rows_s_per_kread: Host seconds in cli.assign's aln_tsv and place_tsv per 1,000 rows of the window."""

from portbench.probes import per_kread

LAYER = "CLI rows and merge"
UNIT = "s"
SOURCE = "program_span"
MOVES = "reads_per_s"
SPANS = [("hmmufotu_tpu_torch.cli.assign", "aln_tsv", "rows"),
         ("hmmufotu_tpu_torch.cli.assign", "place_tsv", "rows")]


def read(run):
    return per_kread(run, "rows")
