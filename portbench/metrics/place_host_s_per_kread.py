"""place_host_s_per_kread: Host seconds in the placement's enqueue and the wait for its summary
(dispatch_place_batch, collect_place_batch; assign_batch_device in the batch
loop) per 1,000 rows of the window."""

from portbench.probes import per_kread

LAYER = "Placement, host side"
UNIT = "s"
SOURCE = "program_span"
MOVES = "reads_per_s"
SPANS = [("hmmufotu_tpu_torch.pipeline", "dispatch_place_batch", "place"),
         ("hmmufotu_tpu_torch.pipeline", "collect_place_batch", "place"),
         ("hmmufotu_tpu_torch.pipeline", "assign_batch_device", "place")]


def read(run):
    return per_kread(run, "place")
