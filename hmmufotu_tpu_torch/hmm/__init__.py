"""Profile-HMM engine: model, training, batched Viterbi alignment."""

from .profile import (GLOBAL, LOCAL, NGCL, CGNL, HmmAlignment, HmmBg,
                      ProfileHMM, ViterbiAlignPath, build_global_align,
                      get_padding_seq)
from .viterbi import (DeviceHMM, ViterbiAligner, banded_regions,
                      full_dp_regions, traceback, viterbi_scan)

__all__ = [
    "ProfileHMM", "HmmBg", "HmmAlignment", "ViterbiAlignPath",
    "GLOBAL", "LOCAL", "NGCL", "CGNL",
    "build_global_align", "get_padding_seq",
    "DeviceHMM", "ViterbiAligner", "banded_regions", "full_dp_regions",
    "traceback", "viterbi_scan",
]
