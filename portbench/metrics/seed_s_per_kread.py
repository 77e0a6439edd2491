"""seed_s_per_kread: Host seconds in pipeline.batch_find_seed_vpaths per 1,000 rows of the window
(the stream runs it on its worker thread)."""

from portbench.probes import per_kread

LAYER = "Seed search"
UNIT = "s"
SOURCE = "program_span"
MOVES = "reads_per_s"
SPANS = [("hmmufotu_tpu_torch.pipeline", "batch_find_seed_vpaths", "seed")]


def read(run):
    return per_kread(run, "seed")
