"""The tree's likelihood messages worked out again, in plain PyTorch f64.

The recursion is the reference's (PhyloTreeUnrooted.cpp:315-374 and the
one two-pass sweep of hmmufotu-build): a node's upward message sums its
children's convolutions log(P(t r) exp(msg)); with discrete-Gamma rates
each rate's sum is taken apart and the rates' mean of exp() is the
node's message.  A child's downward message sums its siblings' and its
parent's downward convolutions the same way.  Leaves carry 0 at their
base and -inf elsewhere, log(pi) at a gap.  Sites are independent, so a
block of columns is computed alone.

Nodes are numbered as the reference numbers a Newick tree (a stack:
children pushed in order, the last popped first), so the branch and
taxon ids of the program's rows name the same nodes here.

Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np

ROOT_NAME = "cellular_organisms"
LEVEL_PREFIXES = ("k__", "p__", "c__", "o__", "f__", "g__", "s__")
LEVEL_CHUNK = 8192


def parse_newick(text: str):
    """(names, parent, brlen) of a Newick string in the reference's node
    numbering; lengths as written in the text."""
    text = text.strip().rstrip(";")
    pos = 0
    stack_nodes = []

    def node():
        nonlocal pos
        children = []
        if text[pos] == "(":
            pos += 1
            while True:
                children.append(node())
                if text[pos] == ",":
                    pos += 1
                    continue
                assert text[pos] == ")"
                pos += 1
                break
        start = pos
        while pos < len(text) and text[pos] not in ",():":
            pos += 1
        name = text[start:pos]
        length = 0.0
        if pos < len(text) and text[pos] == ":":
            pos += 1
            start = pos
            while pos < len(text) and text[pos] not in ",()":
                pos += 1
            length = float(text[start:pos])
        return (name, length, children)

    import sys
    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 100000))
    try:
        root = node()
    finally:
        sys.setrecursionlimit(limit)
    names, parent, brlen = [], [], []
    stack_nodes.append((root, -1))
    while stack_nodes:
        (name, length, children), pid = stack_nodes.pop()
        vid = len(names)
        names.append(name)
        parent.append(pid)
        brlen.append(length if pid >= 0 else 0.0)
        for ch in children:
            stack_nodes.append((ch, vid))
    return names, np.asarray(parent, np.int64), np.asarray(brlen, np.float64)


def node_anno(names, lineage_of: dict) -> list[str]:
    """Each node's taxon as the reference annotates it: a leaf whose
    lineage names all ranks in order carries it; any other node walks
    up to such a node, and past the root takes the root's name.  Here
    only leaves are named."""
    out = []
    for nm in names:
        lin = lineage_of.get(nm, "")
        f = [x for x in lin.replace(" ", ";").split(";") if x]
        full = bool(f) and len(f) <= len(LEVEL_PREFIXES) and all(
            x.startswith(LEVEL_PREFIXES[i]) and len(x) > 3
            for i, x in enumerate(f))
        out.append(";".join(f) if full else ROOT_NAME)
    return out


def gamma_rates_sum1(alpha: float, k: int) -> np.ndarray:
    """The reference's discrete-Gamma rates (DiscreteGammaModel.cpp:
    40-55): k equal-probability categories, their mean rates without the
    factor k, so the k rates sum to 1."""
    from scipy.special import gammainc, gammaincinv
    b = np.r_[0.0, [gammaincinv(alpha, i / k) / alpha for i in range(1, k)],
              np.inf]
    hi = np.where(np.isinf(b[1:]), 1.0,
                  gammainc(alpha + 1, np.where(np.isinf(b[1:]), 0, b[1:])
                           * alpha))
    return hi - gammainc(alpha + 1, b[:-1] * alpha)


class RefTree:
    """Plain arrays of one reference tree: topology, lengths, leaf rows
    (codes [N, L] int8 in node order, -1 where no base), model, rates."""

    def __init__(self, parent, brlen, leaf_codes, is_leaf, model,
                 rates=None):
        self.parent = parent
        self.brlen = brlen
        self.codes = leaf_codes
        self.is_leaf = is_leaf
        self.model = model
        self.rates = None if rates is None else np.asarray(rates, float)
        N = len(parent)
        depth = np.zeros(N, np.int64)
        order = [int(np.nonzero(parent < 0)[0][0])]
        self.root = order[0]
        kids = [[] for _ in range(N)]
        for v in range(N):
            if parent[v] >= 0:
                kids[parent[v]].append(v)
        for u in order:
            for c in kids[u]:
                depth[c] = depth[u] + 1
                order.append(c)
        self.depth = depth
        self.levels = [np.sort(np.nonzero(depth == d)[0])
                       for d in range(int(depth.max()) + 1)]

    def _p(self, torch, dev):
        rates = np.ones(1) if self.rates is None else self.rates
        P = self.model.pr_batch(self.brlen[:, None] * rates[None, :])
        return torch.as_tensor(P, dtype=torch.float64, device=dev)

    def messages(self, c0: int, c1: int, dev, up_only=False):
        """(up, down) [N, 4, c1 - c0] f64 tensors on dev for columns
        [c0, c1); down is None with up_only."""
        import torch
        N, w = len(self.parent), c1 - c0
        P = self._p(torch, dev)                                 # [N, R, 4, 4]
        R = P.shape[1]
        parent = torch.as_tensor(self.parent, device=dev)
        log_pi = torch.as_tensor(np.log(self.model.pi), dtype=torch.float64,
                                 device=dev)
        up = torch.zeros((N, 4, w), dtype=torch.float64, device=dev)
        leaves = np.nonzero(self.is_leaf)[0]
        for lo in range(0, len(leaves), LEVEL_CHUNK):
            ids = leaves[lo:lo + LEVEL_CHUNK]
            codes = torch.as_tensor(self.codes[ids, c0:c1].astype(np.int64),
                                    device=dev)
            lf = log_pi[None, :, None].expand(len(ids), 4, w).clone()
            obs = codes >= 0
            onehot = torch.nn.functional.one_hot(codes.clamp(min=0), 4)
            onehot = onehot.permute(0, 2, 1).to(torch.float64)
            base = torch.log(onehot)                              # 0 / -inf
            lf = torch.where(obs[:, None, :], base, lf)
            up[torch.as_tensor(ids, device=dev)] = lf

        def conv(ids, src, r):
            V = src[ids]
            m = V.amax(1, keepdim=True)
            return torch.log(P[ids, r] @ torch.exp(V - m)) + m

        def mix(acc):
            if R == 1:
                return acc[..., 0]
            return torch.logsumexp(acc, -1) - math.log(R)

        for d in range(len(self.levels) - 1, 0, -1):
            for ch in self._chunks(d, dev):
                par, inv = torch.unique(parent[ch], return_inverse=True)
                acc = torch.zeros((len(par), 4, w, R), dtype=torch.float64,
                                  device=dev)
                for r in range(R):
                    acc[..., r].index_add_(0, inv, conv(ch, up, r))
                up[par] = mix(acc)
        if up_only:
            return up, None
        down = torch.zeros_like(up)
        for d in range(1, len(self.levels)):
            for ch in self._chunks(d, dev):
                par, inv = torch.unique(parent[ch], return_inverse=True)
                has_pp = parent[par] >= 0
                out = torch.empty((len(ch), 4, w, R), dtype=torch.float64,
                                  device=dev)
                for r in range(R):
                    c = conv(ch, up, r)
                    tot = torch.zeros((len(par), 4, w), dtype=torch.float64,
                                      device=dev)
                    tot.index_add_(0, inv, c)
                    if bool(has_pp.any()):
                        tot[has_pp] += conv(par[has_pp], down, r)
                    out[..., r] = tot[inv] - c
                down[ch] = mix(out)
        return up, down

    def _chunks(self, d: int, dev):
        """The nodes of depth d in chunks of at most about LEVEL_CHUNK,
        never splitting one parent's children."""
        import torch
        ch = self.levels[d]
        ch = ch[np.argsort(self.parent[ch], kind="stable")]
        par = self.parent[ch]
        cuts = [0]
        while cuts[-1] < len(ch):
            e = min(cuts[-1] + LEVEL_CHUNK, len(ch))
            while e < len(ch) and par[e] == par[e - 1]:
                e += 1
            cuts.append(e)
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            yield torch.as_tensor(ch[lo:hi], device=dev)

    def states(self, up, c0: int, c1: int):
        """[N, c1 - c0] int8: a leaf's own codes, an inner node's first
        most likely base (the reference's inferSeq)."""
        import torch
        st = up.argmax(1).to(torch.int8)
        leaf = torch.as_tensor(np.nonzero(self.is_leaf)[0], device=up.device)
        st[leaf] = torch.as_tensor(self.codes[leaf.cpu().numpy(), c0:c1],
                                   device=up.device)
        return st


def estimate_alpha(tree: RefTree, dev, block: int = 1024) -> float:
    """The discrete-Gamma shape the reference's builder fits: under the
    one-rate model, per site the number of branches whose two ends'
    most likely bases (argmax of the upward message, leaves included)
    differ, then the moment estimate m^2 / (s^2 - m)."""
    import torch
    L = tree.codes.shape[1]
    counts = []
    parent = torch.as_tensor(tree.parent, device=dev)
    mask = parent >= 0
    for c0 in range(0, L, block):
        c1 = min(c0 + block, L)
        up, _ = tree.messages(c0, c1, dev, up_only=True)
        st = up.argmax(1)
        counts.append((st[mask] != st[parent[mask]]).sum(0).cpu().numpy())
        del up, st
    X = np.concatenate(counts).astype(np.float64)
    m = X.mean()
    s = ((X - m) ** 2).sum() / (len(X) - 1)
    return float(m * m / (s - m))
