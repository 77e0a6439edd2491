"""Frozen copy of tests/oracle/ref_model.py (commit 7ecd7fc), part of the benchmark's
plain reference; the original stays in place.  Only its GTR form is
kept (the benchmark's models are GTR), read from a .sm file, with P(v)
for an array of lengths and its entries clamped at 0.

Oracle substitution models: literal f64 transcriptions of the
reference's closed-form P(v) (JC69.h:97-101, K80.h:110-122,
F81.h:110-119, HKY85.h:111-153, TN93.h:113-155) and the GTR
eigendecomposition form (GTR.h:116-121, GTR.cpp:124-145).

Parameters are read off a production SubModel instance as plain data;
every formula here is re-derived from the reference headers, not from
hmmufotu_tpu.phylo.models.
"""

from __future__ import annotations

import math

import numpy as np

A, C, G, T = 0, 1, 2, 3


class RefModel:
    """P(v) oracle for one trained substitution model."""

    def __init__(self, kind: str, pi: np.ndarray, params: dict):
        self.kind = kind
        self.pi = np.asarray(pi, dtype=np.float64).copy()
        self.params = params
        if kind == "GTR":
            # reference GTR caches EigenSolver results of Q
            # (GTR.cpp:134-145); plain non-symmetric eig here
            Q = np.asarray(params["Q"], dtype=np.float64)
            lam, U = np.linalg.eig(Q)
            self.lam = np.real(lam)
            self.U = np.real(U)
            self.U_1 = np.linalg.inv(self.U)


    @classmethod
    def from_sm_file(cls, path: str) -> "RefModel":
        """A GTR model from a .sm file's Type, pi and Q sections (the
        benchmark's own reader, not the program's)."""
        tags: dict[str, list[str]] = {}
        cur = None
        with open(path) as fh:
            for line in fh:
                if line.lstrip().startswith("#"):
                    continue
                for tok in line.split():
                    if tok.endswith(":"):
                        cur = tok[:-1]
                        tags[cur] = []
                    elif cur is not None:
                        tags[cur].append(tok)
        kind = tags["Type"][0]
        if kind != "GTR":
            raise ValueError(f"{path}: only GTR is read here, not {kind}")
        pi = np.array([float(x) for x in tags["pi"]])
        Q = np.array([float(x) for x in tags["Q"]]).reshape(4, 4)
        return cls(kind, pi, {"Q": Q})

    def pr_batch(self, v: np.ndarray) -> np.ndarray:
        """P(v) of the GTR form for an array of branch lengths:
        [..., 4, 4]."""
        v = np.asarray(v, dtype=np.float64)
        e = np.exp(self.lam * v[..., None])                 # [..., 4]
        P = np.einsum("ij,...j,jk->...ik", self.U, e, self.U_1)
        return np.where(v[..., None, None] == 0, np.eye(4),
                        np.maximum(P, 0.0))

    # ------------------------------------------------------------------
    def Pr(self, v: float) -> np.ndarray:
        if self.kind != "GTR":
            raise ValueError(f"only GTR is kept here, not {self.kind}")
        return self._pr_gtr(float(v))

    def _pr_gtr(self, v: float) -> np.ndarray:
        # GTR.h:116-121; entries clamped at 0 (the benchmark's copy: at
        # a branch near 0 the eigen form rounds a few below 0, and their
        # log would be nan)
        if v == 0:
            return np.eye(4)
        return np.maximum(self.U @ np.diag(np.exp(self.lam * v)) @ self.U_1,
                          0.0)
