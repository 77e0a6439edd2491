"""OTU accumulators and abundance table.

reference: src/OTUObserved.{h,cpp} (per-OTU base-frequency and
per-sample count accumulator, OTUObserved.h:40-90) and
src/OTUTable.{h,cpp} (OTU x sample matrix with add/remove/prune,
constant normalization :110, uniform/multinomial rarefaction
:166-209, merge via operator+= :211-240, TSV load/save :123-164).

Counterpart of hmmufotu_tpu/otu/table.py (host numpy, no device work).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class OTUObserved:
    """Accumulator for one OTU (reference OTUObserved.h:40-90)."""
    otu_id: str
    taxon: str
    cs_len: int
    n_samples: int
    count: np.ndarray = field(default=None)     # [n_samples]
    freq: np.ndarray = field(default=None)      # [4, cs_len]
    gap: np.ndarray = field(default=None)       # [cs_len]

    def __post_init__(self):
        if self.count is None:
            self.count = np.zeros(self.n_samples)
        if self.freq is None:
            self.freq = np.zeros((4, self.cs_len))
        if self.gap is None:
            self.gap = np.zeros(self.cs_len)

    @property
    def total(self) -> float:
        return float(self.count.sum())

    def add_seq(self, sample_idx: int, codes: np.ndarray):
        """Accumulate an aligned digital seq into this OTU."""
        self.count[sample_idx] += 1
        valid = codes >= 0
        cols = np.nonzero(valid)[0]
        np.add.at(self.freq, (codes[cols], cols), 1.0)
        self.gap += ~valid


class OTUTable:
    """OTU x sample abundance matrix + taxonomy map."""

    def __init__(self):
        self.samples: list[str] = []
        self.otus: list[str] = []
        self.metric = np.zeros((0, 0))
        self.otu2taxon: dict[str, str] = {}

    # ----- basic ----------------------------------------------------------
    @property
    def num_samples(self) -> int:
        return len(self.samples)

    @property
    def num_otus(self) -> int:
        return len(self.otus)

    def is_empty(self) -> bool:
        return self.metric.size == 0

    def add_sample(self, name: str) -> int:
        if name in self.samples:
            return self.samples.index(name)
        self.samples.append(name)
        old = self.metric.reshape(self.num_otus, len(self.samples) - 1)
        self.metric = np.concatenate(
            [old, np.zeros((self.num_otus, 1))], axis=1)
        return len(self.samples) - 1

    def add_otu(self, otu_id: str, taxon: str,
                counts: np.ndarray | None = None) -> int:
        if otu_id in self.otus:
            return self.otus.index(otu_id)
        self.otus.append(otu_id)
        self.otu2taxon[otu_id] = taxon
        row = np.zeros((1, self.num_samples)) if counts is None \
            else np.asarray(counts,
                            dtype=np.float64).reshape(1, self.num_samples)
        old = self.metric.reshape(len(self.otus) - 1, self.num_samples)
        self.metric = np.concatenate([old, row], axis=0)
        return len(self.otus) - 1

    def remove_sample(self, j: int):
        self.samples.pop(j)
        self.metric = np.delete(self.metric, j, axis=1)

    def remove_otu(self, i: int):
        self.otu2taxon.pop(self.otus[i], None)
        self.otus.pop(i)
        self.metric = np.delete(self.metric, i, axis=0)

    def get_taxon(self, otu_id: str) -> str:
        return self.otu2taxon.get(otu_id, "")

    # ----- filters (reference OTUTable.cpp:89-108) ------------------------
    def prune_samples(self, min_read: int):
        if min_read == 0:
            return
        for j in range(self.num_samples - 1, -1, -1):
            if self.metric[:, j].sum() < min_read:
                self.remove_sample(j)

    def prune_otus(self, min_read: int):
        for i in range(self.num_otus - 1, -1, -1):
            n = self.metric[i].sum()
            if (min_read > 0 and n < min_read) \
                    or (min_read == 0 and n == 0):
                self.remove_otu(i)

    # ----- normalization (reference OTUTable.cpp:110-122) -----------------
    def normalize_const(self, z: float = 0.0):
        if self.is_empty() or (self.metric == 0).all():
            return
        if z == 0:
            z = self.metric.sum(axis=0).max()
        norm = self.metric.sum(axis=0) / z
        with np.errstate(divide="ignore", invalid="ignore"):
            self.metric = np.where(norm[None, :] > 0,
                                   self.metric / norm[None, :],
                                   self.metric)

    # ----- rarefaction (reference OTUTable.cpp:166-209) -------------------
    def subset_uniform(self, min_read: int,
                       rng: np.random.Generator | None = None):
        """Per-sample subsampling without replacement."""
        rng = rng or np.random.default_rng()
        for j in range(self.num_samples):
            total = int(self.metric[:, j].sum())
            if total <= min_read:
                continue
            picked = np.zeros(total, dtype=bool)
            picked[rng.choice(total, size=min_read, replace=False)] = True
            k = 0
            for i in range(self.num_otus):
                n = int(self.metric[i, j])
                self.metric[i, j] = picked[k:k + n].sum()
                k += n

    def subset_multinom(self, min_read: int,
                        rng: np.random.Generator | None = None):
        """Per-sample multinomial resampling with replacement."""
        rng = rng or np.random.default_rng()
        for j in range(self.num_samples):
            total = self.metric[:, j].sum()
            if total <= min_read:
                continue
            p = self.metric[:, j] / total
            self.metric[:, j] = rng.multinomial(min_read, p)

    # ----- merge (reference OTUTable.cpp:211-240) -------------------------
    def __iadd__(self, other: "OTUTable") -> "OTUTable":
        if self.is_empty() and not other.is_empty():
            self.samples = list(other.samples)
            self.otus = list(other.otus)
            self.metric = other.metric.copy()
            self.otu2taxon = dict(other.otu2taxon)
            return self
        if other.is_empty():
            return self
        for s in other.samples:
            self.add_sample(s)
        for o in other.otus:
            self.add_otu(o, other.get_taxon(o))
        col = {s: j for j, s in enumerate(self.samples)}
        row = {o: i for i, o in enumerate(self.otus)}
        for i, o in enumerate(other.otus):
            for j, s in enumerate(other.samples):
                self.metric[row[o], col[s]] += other.metric[i, j]
        return self

    # ----- text IO (reference OTUTable.cpp:123-164) ------------------------
    def save_table(self, path_or_stream):
        fh = (open(path_or_stream, "w")
              if isinstance(path_or_stream, (str, os.PathLike))
              else path_or_stream)
        try:
            fh.write("otuID\t" + "\t".join(self.samples) + "\ttaxonomy\n")
            for i, otu in enumerate(self.otus):
                vals = "\t".join(f"{v:g}" for v in self.metric[i])
                fh.write(f"{otu}\t{vals}\t{self.otu2taxon[otu]}\n")
        finally:
            if isinstance(path_or_stream, (str, os.PathLike)):
                fh.close()

    @classmethod
    def load_table(cls, path_or_stream) -> "OTUTable":
        fh = (open(path_or_stream)
              if isinstance(path_or_stream, (str, os.PathLike))
              else path_or_stream)
        tab = cls()
        try:
            for line in fh:
                line = line.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                if line.startswith("otuID"):
                    headers = line.split("\t")
                    tab.samples = headers[1:-1]
                    tab.metric = np.zeros((0, len(tab.samples)))
                else:
                    f = line.split("\t")
                    otu_id = f[0]
                    counts = np.array([float(x)
                                       for x in f[1:1 + tab.num_samples]])
                    taxon = f[1 + tab.num_samples] \
                        if len(f) > 1 + tab.num_samples else ""
                    tab.add_otu(otu_id, taxon, counts)
        finally:
            if isinstance(path_or_stream, (str, os.PathLike)):
                fh.close()
        return tab
