"""Data and tree parallelism over devices and processes.

Counterpart of hmmufotu_tpu/parallel: the DB replicated on each device
(or its message tensors split in node blocks), read batches split over
a mesh of devices, reads split over processes, OTU counts summed across
both.  The reference has no distributed computing; its parallelism is
OpenMP threads in one process (reference src/hmmufotu.cpp:603-610).
"""

from .distributed import host_shard, init_distributed
from .sharding import (make_mesh, sharded_assign_step,
                       sharded_otu_accumulate, sharded_place_batch,
                       sharded_place_batch_tree)

__all__ = ["make_mesh", "sharded_assign_step", "sharded_otu_accumulate",
           "sharded_place_batch", "sharded_place_batch_tree",
           "init_distributed", "host_shard"]
