"""Reference-DB inputs and read traffic, made from seeds.

Frozen copy of scripts/evolved_inputs.py (commit 7ecd7fc): synth_inputs
evolves leaf sequences down a random bisection tree under the gg_97 GTR
model with 4 Gamma rate classes, and simulate_reads draws mutated leaf
windows.  Changed in the copy, with the same draws in the same order:

- the GTR transition matrices come from the benchmark's own model
  (reference.ref_model, read from portbench/data), all edges at once;
- the tree, the leaves' aligned codes and the taxonomy are returned as
  arrays as well as written as the three files the build CLI reads;
- simulate_reads works on an int8 code matrix and builds each read's
  string with one table lookup (the same reads as the per-character
  join); simulate_pairs adds paired mates from one leaf fragment.

Imports nothing of the program.
"""

from __future__ import annotations

import os

import numpy as np

from .reference.ref_model import RefModel

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SM_FILE = os.path.join(DATA, "gg_97_otus_GTR.sm")
DM_FILE = os.path.join(DATA, "gg_97_otus.dm")
FASTA, TREE, TAXONOMY = "synth.fasta", "synth.tree", "synth_taxonomy.txt"
ACGT = np.frombuffer(b"ACGT", np.uint8)
COMP = np.frombuffer(b"TGCA", np.uint8)
RANKS = ("k", "p", "c", "o", "f", "g", "s")


def gamma_rates(alpha: float, k: int) -> np.ndarray:
    """Mean rates of k equal-probability Gamma(alpha, alpha) categories
    (Yang 1994), normalised to mean 1."""
    from scipy.special import gammainc
    from scipy.stats import gamma
    cuts = gamma.ppf(np.arange(1, k) / k, alpha, scale=1.0 / alpha)
    upper = gammainc(alpha + 1, np.r_[cuts, np.inf] * alpha)
    lower = gammainc(alpha + 1, np.r_[0.0, cuts] * alpha)
    r = (upper - lower) * k
    return r / r.mean()


def synth_inputs(d: str, n_leaves: int, n_cols: int, seed: int,
                 alpha: float = 0.5, n_rates: int = 4):
    """Write an MSA fasta, a Newick tree and a 7-rank taxonomy for a
    random tree of n_leaves leaves whose sequences evolve down the tree
    (GTR, Gamma rates); about a fifth of the columns are gap-rich.
    Returns a dict of arrays: parent, brlen (generator numbering, node 0
    the root), leaf (leaf node ids in name order S0, S1, ...), codes
    ([n_leaves, n_cols] int8, -1 for a gap), lineage (formatted
    taxonomy per leaf)."""
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    parent, brlen, depth, path = [-1], [0.0], [0], [()]
    leaf_nodes = []
    stack = [(0, n_leaves)]
    while stack:
        u, n = stack.pop()
        if n == 1:
            leaf_nodes.append(u)
            continue
        k = int(rng.integers(1, n))
        for j, m in enumerate((k, n - k)):
            v = len(parent)
            parent.append(u)
            brlen.append(float(rng.exponential(0.06 if m == 1 else 0.03)))
            depth.append(depth[u] + 1)
            path.append(path[u] + (j,))
            stack.append((v, m))
    N = len(parent)
    children = [[] for _ in range(N)]
    for v in range(1, N):
        children[parent[v]].append(v)
    model = RefModel.from_sm_file(SM_FILE)
    rates = gamma_rates(alpha, n_rates)
    cat = rng.integers(0, len(rates), n_cols)
    seq = np.zeros((N, n_cols), np.int8)
    seq[0] = rng.choice(4, n_cols, p=model.pi)
    order = [0]
    for u in order:
        order.extend(children[u])
    cum = np.cumsum(model.pr_batch(np.asarray(brlen)[:, None]
                                   * rates[None, :]), axis=-1)
    for v in order[1:]:
        rows = cum[v][cat, seq[parent[v]]]                  # [n_cols, 4]
        u01 = rng.random(n_cols)[:, None]
        seq[v] = np.minimum((u01 > rows).sum(1), 3)
    gap_p = np.where(rng.random(n_cols) < 0.2, 0.9, 0.02)
    leaves = np.array(sorted(leaf_nodes), np.int64)
    names = {int(v): f"S{i}" for i, v in enumerate(leaves)}
    codes = np.empty((len(leaves), n_cols), np.int8)
    with open(os.path.join(d, FASTA), "w") as fh:
        for i, v in enumerate(leaves):
            c = seq[v].copy()
            c[rng.random(n_cols) < gap_p] = -1
            codes[i] = c
            s = np.where(c >= 0, ACGT[np.maximum(c, 0)], ord("-"))
            fh.write(f">{names[int(v)]}\n{s.astype(np.uint8).tobytes().decode()}\n")
    text = {}
    for v in reversed(order):
        body = (f"({','.join(text.pop(c) for c in children[v])})"
                if children[v] else names[v])
        text[v] = body if v == 0 else f"{body}:{brlen[v]:.6g}"
    with open(os.path.join(d, TREE), "w") as fh:
        fh.write(text[0] + ";\n")
    lineage = []
    with open(os.path.join(d, TAXONOMY), "w") as fh:
        for v in leaves:
            p = path[v]
            lin = ["k__Bacteria"] + [
                f"{r}__{r.upper()}{''.join(map(str, p[:2 * lv]))}"
                for lv, r in enumerate(RANKS[1:], start=1)]
            fh.write(f"{names[int(v)]}\t{'; '.join(lin)}\n")
            lineage.append(";".join(lin))
    return dict(parent=np.asarray(parent, np.int64),
                brlen=np.asarray(brlen, np.float64), leaf=leaves,
                codes=codes, lineage=np.asarray(lineage))


def _pick(codes, rng, length, region):
    """One draw of the copied simulate_reads loop: (leaf row, its
    non-gap columns) until a leaf long enough comes up."""
    while True:
        i = int(rng.choice(codes.shape[0]))
        pos = np.nonzero(codes[i] >= 0)[0]
        if region is not None:
            pos = pos[(pos >= region[0]) & (pos < region[1])]
        if len(pos) >= length + 10:
            return i, pos


def _mutate(piece, rng, sub_rate):
    mut = rng.random(len(piece)) < sub_rate
    piece[mut] = rng.integers(0, 4, int(mut.sum()))
    return piece


def simulate_reads(codes, rng, n, length=250, region=None, sub_rate=0.02):
    """Mutated leaf windows: n reads of `length` bases, each from a leaf
    drawn uniformly, every base in MSA columns [lo, hi) when region is
    given.  codes: [n_leaves, n_cols] int8 leaf rows (-1 gap)."""
    reads = []
    while len(reads) < n:
        i, pos = _pick(codes, rng, length, region)
        st = int(rng.integers(0, len(pos) - length - 5))
        piece = _mutate(codes[i][pos[st:st + length]].copy(), rng, sub_rate)
        reads.append(ACGT[piece].tobytes().decode())
    return reads


def simulate_pairs(codes, rng, n, length=250, frag_mean=500.0,
                   frag_sd=30.0, sub_rate=0.02):
    """n read pairs: a fragment of N(frag_mean, frag_sd^2) columns of a
    leaf, its first `length` bases forward and its last `length` bases
    reverse-complemented, with `sub_rate` substitutions over the
    fragment.  Fragments with fewer than length + 10 bases are drawn
    again."""
    fwd, rev = [], []
    n_cols = codes.shape[1]
    while len(fwd) < n:
        i = int(rng.choice(codes.shape[0]))
        span = int(round(rng.normal(frag_mean, frag_sd)))
        s0 = int(rng.integers(0, max(n_cols - span, 1)))
        row = codes[i][s0:s0 + span]
        bases = row[row >= 0].copy()
        if len(bases) < length + 10:
            continue
        bases = _mutate(bases, rng, sub_rate)
        fwd.append(ACGT[bases[:length]].tobytes().decode())
        rev.append(COMP[bases[-length:][::-1]].tobytes().decode())
    return fwd, rev


def revcom(s: str) -> str:
    b = np.frombuffer(s.encode(), np.uint8)
    lut = np.arange(256, dtype=np.uint8)
    lut[np.frombuffer(b"ACGTacgt", np.uint8)] = np.frombuffer(b"TGCAtgca",
                                                             np.uint8)
    return lut[b[::-1]].tobytes().decode()
