"""Multiple sequence alignment container with vectorized statistics.

reference: src/MSA.h:63, src/MSA.cpp — per-column residue/gap counts
(updateRawCounts, MSA.cpp:227-253), Henikoff position-based sequence
weights (updateSeqWeight, MSA.cpp:256-278), weighted counts
(updateWeightedCounts, MSA.cpp:280-291), consensus calculation
(calculateCS, MSA.cpp:211-226), prune of residue-free columns
(MSA.cpp:87-138).

The alignment is stored as a [num_seq, cs_len] uint8 char matrix; all
statistics are computed with numpy in f64 to match the reference's Eigen
math.  Serialization uses an npz container instead of the reference's raw
binary stream.
"""

from __future__ import annotations

import os

import numpy as np

from .alphabet import DNA, GAP_BASE, DegenAlphabet, get_alphabet
from .io.npz import NpzReader, write_npz
from .seq import read_seqs


class MSA:
    def __init__(self, abc: DegenAlphabet = DNA, name: str = ""):
        self.abc = abc
        self.name = name
        self.names: list[str] = []
        self.chars = np.zeros((0, 0), dtype=np.uint8)  # [N, L] raw chars
        self.is_pruned = False
        self._stats_valid = False

    # --- construction ----------------------------------------------------
    @classmethod
    def load_fasta(cls, path_or_stream, abc: DegenAlphabet = DNA,
                   name: str = "") -> "MSA":
        msa = cls(abc, name)
        names, rows = [], []
        L = None
        for rec in read_seqs(path_or_stream, "fasta", abc):
            if L is None:
                L = len(rec.seq)
            elif len(rec.seq) != L:
                raise ValueError(
                    f"Unmatched sequence length for {rec.id}: "
                    f"{len(rec.seq)} != {L}")
            names.append(rec.id)
            rows.append(np.frombuffer(rec.seq.encode(), dtype=np.uint8))
        if not rows:
            raise ValueError("empty MSA input")
        msa.names = names
        msa.chars = np.stack(rows)
        msa._update_stats()
        return msa

    @classmethod
    def from_arrays(cls, names, chars: np.ndarray, abc: DegenAlphabet = DNA,
                    name: str = "") -> "MSA":
        msa = cls(abc, name)
        msa.names = list(names)
        msa.chars = np.asarray(chars, dtype=np.uint8)
        msa._update_stats()
        return msa

    # --- basic accessors ---------------------------------------------------
    @property
    def num_seq(self) -> int:
        return self.chars.shape[0]

    @property
    def cs_len(self) -> int:
        return self.chars.shape[1]

    def residual_at(self, i: int, j: int) -> str:
        return chr(self.chars[i, j])

    def encode_at(self, i: int, j: int) -> int:
        return int(self.codes[i, j])

    def seq_name_at(self, i: int) -> str:
        return self.names[i]

    def ds_at(self, i: int) -> np.ndarray:
        """Encoded int8 row (DigitalSeq equivalent; invalid chars dropped to
        gap is NOT done — matches reference DigitalSeq which skips invalid
        chars; here MSA rows contain only valid/gap chars)."""
        return self.codes[i]

    def seq_start(self, i: int) -> int:
        return int(self.start_idx[i])

    def seq_end(self, i: int) -> int:
        return int(self.end_idx[i])

    def seq_length(self, i: int) -> int:
        return int(self.len_idx[i])

    def get_seq_weight(self, i: int) -> float:
        return float(self.seq_weight[i])

    # --- statistics (vectorized equivalents of update*Counts) -------------
    def _update_stats(self):
        chars = self.chars
        # uppercase view for counting (reference ::toupper, MSA.cpp:236)
        up = np.where((chars >= 97) & (chars <= 122), chars - 32, chars)
        codes = self.abc.encode(up)          # int8 [N, L]
        self.codes = codes
        N, L = chars.shape
        S = self.abc.size

        is_res = codes >= 0
        is_gap = codes == GAP_BASE

        # raw counts: resCount [S, L], gapCount [L]
        self.res_count = np.zeros((S, L), dtype=np.int64)
        for b in range(S):
            self.res_count[b] = (codes == b).sum(axis=0)
        self.gap_count = is_gap.sum(axis=0).astype(np.int64)

        # per-seq start/end/len over symbol positions
        any_res = is_res.any(axis=1)
        first = is_res.argmax(axis=1)
        last = L - 1 - is_res[:, ::-1].argmax(axis=1)
        self.start_idx = np.where(any_res, first, -1)
        self.end_idx = np.where(any_res, last, -1)
        self.len_idx = is_res.sum(axis=1)

        # Henikoff position-specific weights (reference MSA.cpp:256-278):
        # pssw(b, j) = r_j * resCount(b, j) with r_j = # distinct residues
        r = (self.res_count != 0).sum(axis=0)           # [L]
        pssw = r[None, :] * self.res_count               # [S, L]
        with np.errstate(divide="ignore"):
            inv = np.where(pssw > 0, 1.0 / pssw, 0.0)    # [S, L]
        w = np.zeros(N)
        for b in range(S):
            w += np.where(codes == b, inv[b][None, :], 0.0).sum(axis=1)
        lens = np.where(self.len_idx > 0, self.len_idx, 1)
        w = np.where(self.len_idx > 0, w / lens, w)
        w *= N / w.sum()
        self.seq_weight = w

        # weighted counts
        self.res_wcount = np.zeros((S, L))
        for b in range(S):
            self.res_wcount[b] = (np.where(codes == b, 1.0, 0.0)
                                  * w[:, None]).sum(axis=0)
        self.gap_wcount = (is_gap * w[:, None]).sum(axis=0)

        # consensus (reference calculateCS, MSA.cpp:211-226)
        cs_codes = self.res_wcount.argmax(axis=0)
        res_max = self.res_wcount.max(axis=0)
        cs = np.frombuffer(self.abc.symbols.encode(), dtype=np.uint8)[cs_codes]
        cs = np.where(res_max >= self.gap_wcount, cs, ord(self.abc.gap_char))
        self.cs = cs.astype(np.uint8).tobytes().decode()
        self._stats_valid = True

    # --- per-column fractions (reference MSA.cpp:55-86) -------------------
    def identity_at(self, j=None):
        v = self.res_count.max(axis=0) / self.num_seq
        return v if j is None else float(v[j])

    def w_identity_at(self, j=None):
        v = self.res_wcount.max(axis=0) / self.num_seq
        return v if j is None else float(v[j])

    def gap_frac(self, j=None):
        v = self.gap_count / self.num_seq
        return v if j is None else float(v[j])

    def gap_wfrac(self, j=None):
        v = self.gap_wcount / (self.res_wcount.sum(axis=0) + self.gap_wcount)
        return v if j is None else float(v[j])

    def sym_frac(self, j=None):
        v = self.res_count.sum(axis=0) / self.num_seq
        return v if j is None else float(v[j])

    def sym_wfrac(self, j=None):
        num = self.res_wcount.sum(axis=0)
        v = num / (num + self.gap_wcount)
        return v if j is None else float(v[j])

    def cs_base_at(self, j: int) -> str:
        return self.cs[j]

    def get_cs(self) -> str:
        return self.cs

    def msa_non_gap_len(self) -> int:
        """Total number of non-gap characters in the alignment
        (reference getMSANonGapLen, used for the CSFM concat length)."""
        return int((self.abc.encode(self.chars) != GAP_BASE).sum())

    def scale_weight(self, r: float):
        """Scale all sequence weights (and derived weighted counts) by
        r (reference MSA::sclaleWeight, MSA.h:517)."""
        self.seq_weight = self.seq_weight * r
        self.res_wcount = self.res_wcount * r
        self.gap_wcount = self.gap_wcount * r

    def sym_wfreq(self, j: int | None = None) -> np.ndarray:
        """Weighted per-column residue frequency vector(s)
        (reference symWFreq used by hmmufotu-train-dm.cpp:267)."""
        return self.res_wcount if j is None else self.res_wcount[:, j]

    # --- prune (reference MSA.cpp:87-138) ---------------------------------
    def prune(self) -> "MSA":
        if self.is_pruned:
            return self
        keep = self.res_count.sum(axis=0) != 0
        if not keep.all():
            self.chars = np.ascontiguousarray(self.chars[:, keep])
            self._update_stats()
        self.is_pruned = True
        return self

    # --- serialization -----------------------------------------------------
    def save(self, path: str):
        write_npz(path, dict(
            fmt=np.array(["hmmufotu-tpu-msa-v1"]),
            alphabet=np.array([self.abc.name]),
            name=np.array([self.name]),
            names=np.array(self.names),
            chars=self.chars,
            is_pruned=np.array([self.is_pruned]),
        ))

    @staticmethod
    def check_format(z, path: str):
        """Raise unless the open npz file z is an MSA database."""
        fmt = str(z["fmt"][0]) if "fmt" in z else ""
        if not fmt.startswith("hmmufotu-tpu-msa-"):
            raise ValueError(
                f"'{path}' is not an hmmufotu-tpu MSA database "
                f"(format tag {fmt!r}); rebuild with cli.build")

    @classmethod
    def load(cls, path: str) -> "MSA":
        with NpzReader(path) as z:
            cls.check_format(z, path)
            abc = get_alphabet(str(z["alphabet"][0]))
            msa = cls.from_arrays([str(n) for n in z["names"]], z["chars"],
                                  abc, str(z["name"][0]))
            msa.is_pruned = bool(z["is_pruned"][0])
        return msa
