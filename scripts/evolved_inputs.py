"""Synthetic reference inputs whose sequences evolve down the tree.

synth_inputs writes the three files the build CLI reads (an MSA fasta, a
Newick tree and a 7-rank taxonomy) for a random tree whose leaf
sequences evolve under the bundled gg_97 GTR model with 4 Gamma rate
classes; simulate_reads draws 250 bp reads from its leaves (2%
substitutions), from anywhere in a leaf or from one column region, the
traffic of a 16S amplicon run.  chip_smoke.py and
scripts/torch_scale_cli.py both use them.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READ_LEN = 250
# file names synth_inputs writes into its directory
FASTA, TREE, TAXONOMY = "synth.fasta", "synth.tree", "synth_taxonomy.txt"


def synth_inputs(d: str, n_leaves: int, n_cols: int, seed: int = 7):
    """Write an MSA fasta, a Newick tree and a taxonomy file for a random
    tree of n_leaves leaves whose sequences evolve down the tree under the
    bundled GTR model with 4 Gamma rate classes (alpha 0.5).  Topology by
    random bisection of the leaf set; branch lengths exponential; about a
    fifth of the columns are gap-rich (insert columns of the profile).
    Returns (nodes, depth of the deepest leaf)."""
    from hmmufotu_tpu_torch.phylo import DiscreteGammaModel, load_model
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    # topology: node 0 is the root; a clade of n >= 2 leaves splits into
    # two clades of uniform random size
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
    # sequences: root from pi, then each edge by P(t * site rate)
    model = load_model(os.path.join(REPO, "hmmufotu_tpu_torch", "data",
                                    "gg_97_otus_GTR.sm"))
    dg = DiscreteGammaModel(0.5, 4)
    rates = np.asarray(dg.rates) * len(dg.rates)     # mean 1
    cat = rng.integers(0, len(rates), n_cols)
    seq = np.zeros((N, n_cols), np.int8)
    seq[0] = rng.choice(4, n_cols, p=np.asarray(model.pi))
    order = [0]
    for u in order:
        order.extend(children[u])
    for v in order[1:]:
        P = np.asarray(model.Pr_batch(brlen[v] * rates))   # [4 rates, 4, 4]
        cum = np.cumsum(P, axis=-1)
        rows = cum[cat, seq[parent[v]]]                     # [n_cols, 4]
        u01 = rng.random(n_cols)[:, None]
        seq[v] = np.minimum((u01 > rows).sum(1), 3)
    gap_p = np.where(rng.random(n_cols) < 0.2, 0.9, 0.02)
    names = {v: f"S{i}" for i, v in enumerate(sorted(leaf_nodes))}
    acgt = np.frombuffer(b"ACGT", np.uint8)
    with open(os.path.join(d, FASTA), "w") as fh:
        for v in sorted(leaf_nodes):
            s = acgt[seq[v]]
            s[rng.random(n_cols) < gap_p] = ord("-")
            fh.write(f">{names[v]}\n{s.tobytes().decode()}\n")
    # Newick, written iteratively (post-order assembly)
    text = {}
    for v in reversed(order):
        body = (f"({','.join(text.pop(c) for c in children[v])})"
                if children[v] else names[v])
        text[v] = body if v == 0 else f"{body}:{brlen[v]:.6g}"
    with open(os.path.join(d, TREE), "w") as fh:
        fh.write(text[0] + ";\n")
    # taxonomy of each leaf from its clade path (7 ranks)
    ranks = ("k", "p", "c", "o", "f", "g", "s")
    with open(os.path.join(d, TAXONOMY), "w") as fh:
        for v in sorted(leaf_nodes):
            p = path[v]
            lin = ["k__Bacteria"] + [
                f"{r}__{r.upper()}{''.join(map(str, p[:2 * lv]))}"
                for lv, r in enumerate(ranks[1:], start=1)]
            fh.write(f"{names[v]}\t{'; '.join(lin)}\n")
    return N, max(depth)


def input_tree(d: str):
    """The tree of synth_inputs' files with its leaves' aligned sequences
    (in the pruned MSA's columns, as the build CLI loads them), for
    simulate_reads; no likelihoods."""
    from hmmufotu_tpu_torch.msa import MSA
    from hmmufotu_tpu_torch.phylo import PTUnrooted, parse_newick
    msa = MSA.load_fasta(os.path.join(d, FASTA))
    msa.prune()
    with open(os.path.join(d, TREE)) as fh:
        tree = PTUnrooted.from_newick(parse_newick(fh.read()))
    tree.load_msa(msa)
    return tree


def simulate_reads(tree, rng, n, length=READ_LEN, leaves=None,
                   region=None):
    """Mutated leaf windows (2% substitutions), as bench.py simulates;
    from every leaf, or from the given ones.  region=(lo, hi): only bases
    in MSA columns [lo, hi), so every read comes from that region."""
    leaves = np.asarray(leaves or [u for u in range(tree.num_nodes)
                                   if tree.is_leaf(u)
                                   and tree.msa_id[u] >= 0])
    reads = []
    while len(reads) < n:
        u = int(rng.choice(leaves))
        pos = np.nonzero(tree.seqs[u] >= 0)[0]
        if region is not None:
            pos = pos[(pos >= region[0]) & (pos < region[1])]
        if len(pos) < length + 10:
            continue
        st = int(rng.integers(0, len(pos) - length - 5))
        piece = tree.seqs[u][pos[st:st + length]].copy()
        mut = rng.random(len(piece)) < 0.02
        piece[mut] = rng.integers(0, 4, int(mut.sum()))
        reads.append("".join("ACGT"[c] for c in piece))
    return reads


def write_fasta(path, reads):
    with open(path, "w") as fh:
        fh.write("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    return path
