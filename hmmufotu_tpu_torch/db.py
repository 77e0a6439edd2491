"""Database container: the 4-artifact DB tying all layers together.

reference: the <db>.msa/.csfm/.hmm/.ptu files sharing a prefix
(src/HmmUFOtuConst.h suffix constants; loaded in src/hmmufotu.cpp:
445-494).  File formats here are npz containers (MSA/CSFM/PTU) plus
the HMMER3/f text profile, the same files as hmmufotu_tpu.db reads;
every npz embeds a format string checked on load (the ProgInfo header equivalent, util/ProgEnv.cpp:18-57).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

from .hmm import ProfileHMM
from .index import CSFMIndex
from .io.npz import NpzReader
from .msa import MSA
from .phylo import PTUnrooted

MSA_SUFFIX = ".msa.npz"
CSFM_SUFFIX = ".csfm.npz"
HMM_SUFFIX = ".hmm"
PTU_SUFFIX = ".ptu.npz"


@dataclass
class Database:
    msa: MSA
    csfm: CSFMIndex
    hmm: ProfileHMM
    ptu: PTUnrooted

    @staticmethod
    def check_files(prefix: str):
        for suf in (MSA_SUFFIX, CSFM_SUFFIX, HMM_SUFFIX, PTU_SUFFIX):
            if not os.path.exists(prefix + suf):
                raise FileNotFoundError(
                    f"database file '{prefix + suf}' not found")

    @classmethod
    def load(cls, prefix: str) -> "Database":
        cls.check_files(prefix)
        msa = MSA.load(prefix + MSA_SUFFIX)
        csfm = CSFMIndex.load(prefix + CSFM_SUFFIX)
        hmm = ProfileHMM.from_hmmer_file(prefix + HMM_SUFFIX)
        ptu = PTUnrooted.load(prefix + PTU_SUFFIX)
        return cls(msa, csfm, hmm, ptu)

    @classmethod
    def load_topology(cls, prefix: str) -> PTUnrooted:
        """The tree's topology alone (PTUnrooted.load_topology), after the
        checks load() makes of the files: all four exist and the three
        npz files carry their format tags (read from their tags alone)."""
        cls.check_files(prefix)
        with NpzReader(prefix + MSA_SUFFIX) as z:
            MSA.check_format(z, prefix + MSA_SUFFIX)
        with NpzReader(prefix + CSFM_SUFFIX) as z:
            CSFMIndex.check_format(z, prefix + CSFM_SUFFIX)
        return PTUnrooted.load_topology(prefix + PTU_SUFFIX)

    def save(self, prefix: str):
        self.msa.save(prefix + MSA_SUFFIX)
        self.csfm.save(prefix + CSFM_SUFFIX)
        self.hmm.to_hmmer_file(prefix + HMM_SUFFIX)
        self.ptu.save(prefix + PTU_SUFFIX)
