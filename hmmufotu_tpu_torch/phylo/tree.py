"""Unrooted phylogenetic tree with cached per-edge likelihood messages.

Array redesign of the reference placement engine (reference:
src/PhyloTreeUnrooted.{h,cpp}).  Instead of a pointer graph with a
``map<node, map<node, branch>>`` of per-edge Eigen matrices
(PhyloTreeUnrooted.h:109,1365), the tree is flattened into plain arrays

    parent[N]      int32  (root = -1)
    brlen[N]       f64    branch length from node to its parent
    seqs[N, L]     int8   encoded node sequences (leaves from the MSA,
                          internal filled by ancestral inference)
    msg_up[N,4,L]  f64    loglik message node -> parent (f32 on a tree
                          loaded from a DB file, as the file stores it;
                          the host readers widen the rows they read)
                          (node2branch[u][parent].loglik in the reference;
                          msg_up[root] holds the root in-message, i.e.
                          node2branch[root][null])
    msg_down[N,4,L] f64   loglik message parent -> node
                          (node2branch[parent][u].loglik)

and all likelihood passes are vectorized over the sites axis.  Where the
reference fills the reversed (parent->child) messages by re-rooting the
tree at EVERY node and re-running Felsenstein sweeps
(src/hmmufotu-build.cpp:455-459, an O(N^2) set of traversals), this
implementation computes every directed-edge message with exactly one
post-order (up) and one pre-order (down) pass — the standard
message-passing identity on trees, valid because the models are
time-reversible (reference PhyloTreeUnrooted.h:22-24).

Numeric conventions follow the reference: conditional log-likelihood
vectors are combined with scaled exp/log dot products
(dot_product_scaled, PhyloTreeUnrooted.h:1495-1519) and discrete-Gamma
rate mixing averages rate-scaled convolutions per node
(row_mean_exp_scaled, PhyloTreeUnrooted.h:1521-1529; loglik(),
PhyloTreeUnrooted.cpp:315-345).
"""

from __future__ import annotations

import io
import json
import os
from dataclasses import dataclass, field

import numpy as np

from ..alphabet import DNA, GAP_BASE
from ..io.npz import NpzReader, write_npz
from .dgamma import DiscreteGammaModel
from .models import SubModel, create_model, load_model
from .newick import NewickNode

INVALID_LOGLIK = 1.0            # PhyloTreeUnrooted.cpp:69
MIN_LOGLIK_EXP = -1021.0 / 2.0  # DBL_MIN_EXP / 2, PhyloTreeUnrooted.cpp:68
BRANCH_EPS = 1e-5               # PhyloTreeUnrooted.cpp:71
MAX_ITER = 100                  # PhyloTreeUnrooted.h MAX_ITER
NEG_INF = -np.inf

TAXON_SEP = ";: "               # PhyloTreeUnrooted.cpp TAXON_SEP
_TAXON_PREFIXES = ("d__", "k__", "p__", "c__", "o__", "f__", "g__", "s__")
_LEVEL_PREFIXES = ("k__", "p__", "c__", "o__", "f__", "g__", "s__")
DEFAULT_ROOT_NAME = "cellular_organisms"
MAX_PDIST = 0.15                # DNASubModel.cpp:39


# --------------------------------------------------------------------------
# scaled log-space primitives (reference PhyloTreeUnrooted.h:1488-1529)
# --------------------------------------------------------------------------

def dot_product_scaled(X: np.ndarray, V: np.ndarray) -> np.ndarray:
    """log(X @ exp(V)) with per-column underflow scaling.

    X: [4, 4] transition matrix; V: [4, L] log-likelihood columns.
    Mirrors dot_product_scaled (PhyloTreeUnrooted.h:1496-1504) but always
    scales by the per-column max (mathematically identical, better
    conditioned for f32 device execution).
    """
    m = V.max(axis=0, keepdims=True)                     # [1, L]
    scale = np.where(np.isfinite(m), m, 0.0)
    with np.errstate(divide="ignore"):
        return np.log(X @ np.exp(V - scale)) + scale


def dot_product_scaled_vec(P: np.ndarray, V: np.ndarray) -> np.ndarray:
    """log(P . exp(V)) columnwise; P: [4], V: [4, L] -> [L]
    (reference PhyloTreeUnrooted.h:1506-1511)."""
    m = V.max(axis=0)
    scale = np.where(np.isfinite(m), m, 0.0)
    with np.errstate(divide="ignore"):
        return np.log(P @ np.exp(V - scale[None, :])) + scale


def row_mean_exp_scaled(X: np.ndarray) -> np.ndarray:
    """log(mean_k(exp(X)))) over the last axis with row scaling.

    X: [4, L, K] rate-convolved messages -> [4, L]
    (reference row_mean_exp_scaled, PhyloTreeUnrooted.h:1521-1529).
    """
    m = X.max(axis=-1, keepdims=True)
    scale = np.where(np.isfinite(m), m, 0.0)
    with np.errstate(divide="ignore"):
        return np.log(np.exp(X - scale).mean(axis=-1)) + scale[..., 0]


def infer_state(loglik: np.ndarray) -> np.ndarray:
    """argmax base per column; loglik [4, ...] -> int8 [...]
    (reference inferState, PhyloTreeUnrooted.h:1584-1588)."""
    return loglik.argmax(axis=0).astype(np.int8)


def infer_weight(loglik: np.ndarray) -> np.ndarray:
    """softmax over bases per column (reference inferWeight,
    PhyloTreeUnrooted.h:1590-1593)."""
    p = np.exp(loglik - loglik.max(axis=0, keepdims=True))
    return p / p.sum(axis=0, keepdims=True)


def p_dist(s1: np.ndarray, s2: np.ndarray, start: int = 0,
           end: int | None = None) -> float:
    """p-distance between two encoded digital seqs over [start, end]
    inclusive; only sites where BOTH are concrete bases count
    (reference SeqUtils::pDist, SeqUtils.cpp:38-54)."""
    if end is None:
        end = len(s1) - 1
    a = s1[start:end + 1]
    b = s2[start:end + 1]
    valid = (a >= 0) & (b >= 0)
    n = int(valid.sum())
    if n == 0:
        return float("nan")
    return float(((a != b) & valid).sum()) / n


# --------------------------------------------------------------------------
# taxonomy-name helpers (reference PhyloTreeUnrooted.cpp:956-1006)
# --------------------------------------------------------------------------

def _split_taxon(taxon: str) -> list[str]:
    out, cur = [], []
    for ch in taxon:
        if ch in TAXON_SEP:
            if cur:
                out.append("".join(cur))
                cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def is_canonical_name(taxon: str) -> bool:
    return len(taxon) > 3 and taxon.startswith(_TAXON_PREFIXES)


def is_canonical_name_at(taxon: str, level: int) -> bool:
    return level < len(_LEVEL_PREFIXES) and \
        taxon.startswith(_LEVEL_PREFIXES[level])


def is_full_canonical_name(taxon: str) -> bool:
    fields = _split_taxon(taxon)
    if not fields:
        return False
    return all(is_canonical_name_at(f, lv) for lv, f in enumerate(fields))


def is_partial_canonical_name(taxon: str) -> bool:
    fields = _split_taxon(taxon)
    if not fields:
        return False
    return all(is_canonical_name(f) for f in fields)


def format_taxon_name(taxon: str) -> str:
    if not taxon:
        return taxon
    return ";".join(f for f in _split_taxon(taxon) if is_canonical_name(f))


# --------------------------------------------------------------------------
# placement PODs (reference PhyloTreeUnrooted.h:390-510)
# --------------------------------------------------------------------------

@dataclass
class PTLoc:
    """Seed location: p-dist of an aligned read to one tree node."""
    start: int
    end: int
    id: int
    dist: float

    def __lt__(self, other):
        return self.dist < other.dist


MAX_Q = 250  # PTPlacement::MAX_Q
UNASSIGNED_TAXONID = -1
UNASSIGNED_TAXONNAME = "UNASSIGNED"
UNASSIGNED_ID = "NULL"
PLACEMENT_TSV_HEADER = ("branch_id\tbranch_ratio\ttaxon_id\ttaxon_anno\t"
                        "anno_dist\tloglik\tQ_placement\tQ_taxon")


@dataclass
class PTPlacement:
    """Candidate placement of a read on a branch (cNode -> pNode)."""
    start: int = 0
    end: int = 0
    c_node: int = -1
    p_node: int = -1
    a_node: int = -1
    wuv: float = float("nan")
    ratio: float = float("nan")
    wnr: float = float("nan")
    loglik: float = float("nan")
    height: float = float("nan")
    q_place: float = float("nan")
    q_taxon: float = float("nan")

    def get_id(self) -> str:
        if self.c_node >= 0 and self.p_node >= 0:
            return f"{self.c_node}->{self.p_node}"
        return UNASSIGNED_ID

    def get_anno_dist(self, tree: "PTUnrooted") -> float:
        if self.a_node == self.c_node:
            return self.wuv * self.ratio + self.wnr
        return (1 - self.ratio) * self.wuv + self.wnr

    def log_prior(self, prior_type: str, tree: "PTUnrooted") -> float:
        """UNIFORM -> 0; HEIGHT -> -(annoDist - wnr + height)
        (reference PTPlacement::logPriorPr, PhyloTreeUnrooted.cpp:1166;
        getAnnoDist there is the PLACEMENT distance only,
        PhyloTreeUnrooted.h:466-469 — the attachment node's own
        annotation distance is NOT included)."""
        if prior_type == "height":
            return -(self.get_anno_dist(tree) - self.wnr + self.height)
        return 0.0


# --------------------------------------------------------------------------
# the tree
# --------------------------------------------------------------------------

class PTUnrooted:
    """Flattened unrooted phylogenetic tree + likelihood message cache."""

    def __init__(self):
        self.cs_len = 0
        self.root = 0
        self.parent = np.zeros(0, dtype=np.int64)
        self.brlen = np.zeros(0)
        self.names: list[str] = []
        self.anno: list[str] = []
        self.anno_dist = np.zeros(0)
        self.heights = np.zeros(0)
        self.seqs = np.zeros((0, 0), dtype=np.int8)  # -128 = unset
        self.has_seq = np.zeros(0, dtype=bool)
        self.msa_id = np.zeros(0, dtype=np.int64)    # node -> msa row or -1
        self.model: SubModel | None = None
        self.dg: DiscreteGammaModel | None = None
        self.msg_up: np.ndarray | None = None
        self.msg_down: np.ndarray | None = None
        # the dtype the host readers compute the messages in: None reads
        # them as stored (a tree evaluated in this process); load() sets
        # f64, which its f32 arrays widen to exactly (the reference
        # package's load widens the whole arrays)
        self.msg_read_dtype = None
        self._children: list[list[int]] | None = None

    # ----- topology -------------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return len(self.names)

    @property
    def num_branches(self) -> int:
        return self.num_nodes - 1

    def children_of(self, u: int) -> list[int]:
        if self._children is None:
            ch: list[list[int]] = [[] for _ in range(self.num_nodes)]
            for v, p in enumerate(self.parent):
                if p >= 0:
                    ch[p].append(v)
            self._children = ch
        return self._children[u]

    def is_leaf(self, u: int) -> bool:
        """Degree-1 node (reference PTUNode::isLeaf: neighbors.size()==1)."""
        deg = len(self.children_of(u)) + (1 if self.parent[u] >= 0 else 0)
        return deg == 1

    def is_tip(self, u: int) -> bool:
        """Internal node whose children are all leaves
        (reference PTUnrooted::isTip, PhyloTreeUnrooted.cpp:91-98)."""
        if self.is_leaf(u):
            return False
        return all(self.is_leaf(c) for c in self.children_of(u))

    def post_order(self) -> np.ndarray:
        """Node ids, children strictly before parents."""
        N = self.num_nodes
        order = np.empty(N, dtype=np.int64)
        idx = N - 1
        stack = [self.root]
        while stack:
            u = stack.pop()
            order[idx] = u
            idx -= 1
            stack.extend(self.children_of(u))
        return order  # reversed pre-order = valid post-order

    # ----- construction ---------------------------------------------------
    @classmethod
    def from_newick(cls, ntree: NewickNode) -> "PTUnrooted":
        """Build from a parsed Newick tree, replicating the reference's
        node-id assignment (stack DFS, children pushed in declaration
        order and popped LIFO: PhyloTreeUnrooted.cpp:131-162)."""
        tree = cls()
        nodes: list[NewickNode] = []
        parents: list[int] = []
        stack: list[tuple[NewickNode, int]] = [(ntree, -1)]
        while stack:
            v, pid = stack.pop()
            vid = len(nodes)
            nodes.append(v)
            parents.append(pid)
            for child in v.children:
                stack.append((child, vid))
        tree.names = [v.name for v in nodes]
        tree.parent = np.array(parents, dtype=np.int64)
        tree.brlen = np.array([v.length for v in nodes])
        tree.brlen[tree.parent < 0] = 0.0
        tree.root = int(np.nonzero(tree.parent < 0)[0][0])
        N = len(nodes)
        tree.anno = [""] * N
        tree.anno_dist = np.zeros(N)
        tree.heights = np.zeros(N)
        tree.msa_id = np.full(N, -1, dtype=np.int64)
        tree.has_seq = np.zeros(N, dtype=bool)
        return tree

    def load_msa(self, msa) -> int:
        """Attach MSA rows to equally named leaves
        (reference loadMSA, PhyloTreeUnrooted.cpp:184-221)."""
        self.cs_len = msa.cs_len
        name2row = {}
        for i, nm in enumerate(msa.names):
            if nm in name2row:
                raise ValueError(f"Non-unique seq name {nm} in MSA")
            name2row[nm] = i
        self.seqs = np.full((self.num_nodes, self.cs_len), -128,
                            dtype=np.int8)
        n = 0
        for u in range(self.num_nodes):
            if not self.is_leaf(u):
                continue
            row = name2row.get(self.names[u])
            if row is None:
                continue
            self.seqs[u] = msa.ds_at(row)
            self.msa_id[u] = row
            self.has_seq[u] = True
            n += 1
        return n

    def load_annotation(self, path_or_stream):
        """Replace node names by annotation strings from a 2-column TSV
        (reference loadAnnotation, PhyloTreeUnrooted.cpp:223-240)."""
        if isinstance(path_or_stream, (str, os.PathLike)):
            fh = open(path_or_stream)
            close = True
        else:
            fh, close = path_or_stream, False
        try:
            name2anno = {}
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    name2anno[parts[0]] = parts[1]
                elif parts and parts[0]:
                    name2anno[parts[0]] = ""
            for u in range(self.num_nodes):
                if self.names[u] in name2anno:
                    self.names[u] = name2anno[self.names[u]]
        finally:
            if close:
                fh.close()

    def format_name(self):
        self.names = [format_taxon_name(n) for n in self.names]

    def fix_branch_length(self, min_len: float):
        """Give zero-length terminal branches a minimum length
        (reference fixBranchLength, PhyloTreeUnrooted.cpp:290-297)."""
        for u in range(self.num_nodes):
            if self.parent[u] >= 0 and self.is_leaf(u) \
                    and self.brlen[u] <= 0:
                self.brlen[u] = min_len

    def annotate(self, root_name: str = DEFAULT_ROOT_NAME):
        """Walk each node up to the nearest (fully) canonically named
        ancestor, accumulating annoDist (reference annotate,
        PhyloTreeUnrooted.cpp:988-1006)."""
        for u in range(self.num_nodes):
            anno_path = []
            p = u
            dist = 0.0
            while not is_full_canonical_name(self.names[p]) \
                    and self.parent[p] >= 0:
                dist += self.brlen[p]
                if is_partial_canonical_name(self.names[p]):
                    anno_path.append(self.names[p])
                p = int(self.parent[p])
            if is_full_canonical_name(self.names[p]):
                anno_path.append(self.names[p])
            anno_path.reverse()
            self.anno[u] = ";".join(anno_path) if anno_path else root_name
            self.anno_dist[u] = dist

    def calc_node_height(self):
        """height = min distance to a descendant leaf
        (reference calcNodeHeight, PhyloTreeUnrooted.cpp:274-287)."""
        h = np.zeros(self.num_nodes)
        for u in self.post_order():
            ch = self.children_of(u)
            if ch:
                h[u] = min(h[c] + self.brlen[c] for c in ch)
        self.heights = h

    def get_taxon(self, u: int, max_dist: float) -> str:
        """anno or anno;Other beyond max_dist (reference getTaxon,
        PhyloTreeUnrooted.h:1580-1582)."""
        return self.anno[u] if self.anno_dist[u] <= max_dist \
            else self.anno[u] + ";Other"

    # ----- likelihood machinery ------------------------------------------
    def _rates(self) -> np.ndarray:
        if self.dg is None:
            return np.ones(1)
        return np.asarray(self.dg.rates)

    def leaf_loglik(self, seq: np.ndarray) -> np.ndarray:
        """[4, L] leaf conditional loglik: 0 at the observed base, -inf
        elsewhere; log(pi) at gaps/invalid (reference getLeafLoglik,
        PhyloTreeUnrooted.h:1431-1437)."""
        L = seq.shape[0]
        out = np.tile(np.log(self.model.pi)[:, None], (1, L))
        obs = seq >= 0
        cols = np.nonzero(obs)[0]
        out[:, cols] = NEG_INF
        out[seq[cols], cols] = 0.0
        return out

    def _read(self, rows: np.ndarray) -> np.ndarray:
        if self.msg_read_dtype is None:
            return rows
        return np.asarray(rows, self.msg_read_dtype)

    def up_rows(self, u: int, sl: slice = slice(None)) -> np.ndarray:
        """[4, *] msg_up[u] over columns sl, in msg_read_dtype: what every
        host reader of the messages computes with."""
        return self._read(self.msg_up[u][:, sl])

    def down_rows(self, u: int, sl: slice = slice(None)) -> np.ndarray:
        """[4, *] msg_down[u] over columns sl, in msg_read_dtype."""
        return self._read(self.msg_down[u][:, sl])

    def _conv_rates(self, msg: np.ndarray, w: float) -> np.ndarray:
        """Rate-scaled convolutions of one incoming message: [4, L, K]
        where K = number of dGamma categories (1 if none)."""
        rates = self._rates()
        out = np.empty(msg.shape + (len(rates),))
        for k, r in enumerate(rates):
            out[:, :, k] = dot_product_scaled(self.model.Pr(w * r), msg)
        return out

    def _node_depths(self) -> np.ndarray:
        """Edge distance from the root per node (root = 0)."""
        depth = np.zeros(self.num_nodes, dtype=np.int64)
        for u in self.post_order()[::-1]:     # pre-order: parent first
            p = self.parent[u]
            if p >= 0:
                depth[u] = depth[p] + 1
        return depth

    def _leaf_loglik_batch(self, ids: np.ndarray, s0: int,
                           s1: int) -> np.ndarray:
        """[n, 4, B] leaf conditional logliks for site block [s0, s1)
        (batched form of leaf_loglik / reference getLeafLoglik)."""
        codes = self.seqs[ids, s0:s1]                      # [n, B]
        n, B = codes.shape
        out = np.broadcast_to(np.log(self.model.pi)[None, :, None],
                              (n, 4, B)).copy()
        ii, bb = np.nonzero(codes >= 0)
        out[ii, :, bb] = NEG_INF
        out[ii, codes[ii, bb], bb] = 0.0
        return out

    @staticmethod
    def _conv_batch(P: np.ndarray, V: np.ndarray) -> np.ndarray:
        """Batched dot_product_scaled: P [n, 4, 4] transition matrices,
        V [n, 4, B] log messages -> [n, 4, B] log(P @ exp(V)) with
        per-column max scaling (PhyloTreeUnrooted.h:1496-1504)."""
        m = V.max(axis=1, keepdims=True)                   # [n, 1, B]
        scale = np.where(np.isfinite(m), m, 0.0)
        with np.errstate(divide="ignore"):
            return np.log(P @ np.exp(V - scale)) + scale

    def _level_plan(self):
        """Shared evaluate() precompute: depth levels (children sorted
        by parent + segment starts), per-edge P(t*rate) matrices, leaf
        sets.  Returns (maxd, lvl, P, seq_leaves, root_is_leaf)."""
        N = self.num_nodes
        rates = self._rates()
        depth = self._node_depths()
        maxd = int(depth.max()) if N else 0
        lvl: list[tuple] = [()] * (maxd + 1)
        for d in range(1, maxd + 1):
            ch = np.nonzero(depth == d)[0]
            ch = ch[np.argsort(self.parent[ch], kind="stable")]
            par = self.parent[ch]
            starts = np.nonzero(np.r_[True, par[1:] != par[:-1]])[0]
            lvl[d] = (ch, starts, par[starts])
        # per-edge transition matrices for every rate: [N, K, 4, 4]
        P = np.asarray(self.model.Pr_batch(
            np.asarray(self.brlen)[:, None] * rates[None, :]))
        leaf_mask = np.array([self.is_leaf(u) for u in range(N)])
        seq_leaves = np.nonzero(leaf_mask & self.has_seq
                                & (self.parent >= 0))[0]
        return maxd, lvl, P, seq_leaves, bool(leaf_mask[self.root])

    def evaluate(self, dtype=np.float64,
                 budget_bytes: int = 2 << 30, engine: str = "numpy",
                 sites: tuple[int, int] | None = None, device="cuda"):
        """Fill msg_up and msg_down for every directed edge with one
        post-order and one pre-order sweep.

        Replaces the reference's per-root evaluate() calls
        (PhyloTreeUnrooted.cpp:358-374) and the N-times re-rooted sweep
        loop of the DB builder (hmmufotu-build.cpp:455-459).

        Scale design: nodes are processed one DEPTH LEVEL at a time with
        all per-node 4x4 convolutions batched into one [n,4,4]@[n,4,B]
        matmul, and the sites axis is processed in blocks sized so the
        working set stays under ``budget_bytes`` — so a gg_97-scale
        tree (~2e5 nodes x ~6e3 sites) evaluates within a bounded RSS.
        ``dtype`` selects the *storage* dtype of the message tensors;
        pass np.float32/np.float16 at reference scale (the .ptu file
        stores f32 regardless, tree.save()).

        ``engine``: "numpy" computes in f64 (reference-exact, used for
        parity); "torch" runs the identical blocked recurrence as f32
        tensor ops on ``device`` (default "cuda"; "cpu" only when asked
        for), the counterpart of the reference package's "jax" engine.
        ``device`` is used by the torch engine only.

        ``sites=(lo, hi)``: fill messages only for CS columns
        [lo, hi).  Per-site independence makes the restriction exact;
        columns outside stay 0 (msg tensors are still allocated
        [N, 4, L], but np.zeros pages are virtual until touched).
        This is the amplicon capacity mode: a window-resident placer
        (placement.DeviceTree site_window) only ever reads the window.
        """
        if engine == "torch":
            return self._evaluate_torch(dtype, budget_bytes, sites, device)
        if engine != "numpy":
            raise ValueError(f"unknown evaluate engine '{engine}'")
        N, L = self.num_nodes, self.cs_len
        rates = self._rates()
        K = len(rates)
        self.msg_up = np.zeros((N, 4, L), dtype=dtype)
        self.msg_down = np.zeros((N, 4, L), dtype=dtype)
        self.msg_read_dtype = None
        if N == 0 or L == 0:
            return

        maxd, lvl, P, seq_leaves, root_is_leaf = self._level_plan()

        # block size: up+down f64 working blocks are ~(2N + 3n_max*K)*32*B
        n_max = max((len(t[0]) for t in lvl[1:]), default=1) or 1
        B = max(16, int(budget_bytes // ((2 * N + 3 * n_max * K) * 32)))
        B = min(B, L)

        lo, hi = (0, L) if sites is None else sites
        for s0 in range(lo, hi, B):
            s1 = min(s0 + B, hi)
            w = s1 - s0
            up = np.zeros((N, 4, w))
            if len(seq_leaves):
                up[seq_leaves] = self._leaf_loglik_batch(seq_leaves, s0, s1)

            # ---- up (post-order by level, deepest first) ----------------
            for d in range(maxd, 0, -1):
                ch, starts, pars = lvl[d]
                if not len(ch):
                    continue
                acc = np.empty((len(pars), 4, w, K))
                for k in range(K):
                    conv = self._conv_batch(P[ch, k], up[ch])
                    acc[:, :, :, k] = np.add.reduceat(conv, starts, axis=0)
                up[pars] = row_mean_exp_scaled(acc) if K > 1 \
                    else acc[:, :, :, 0]
            if root_is_leaf and self.has_seq[self.root]:
                # degree-1 root adds its own seq term (loglik(node) parity)
                up[self.root] += self._leaf_loglik_batch(
                    np.array([self.root]), s0, s1)[0]
            self.msg_up[:, :, s0:s1] = up

            # ---- down (pre-order by level) -------------------------------
            dn = np.zeros((N, 4, w))
            for d in range(0, maxd):
                ch, starts, pars = lvl[d + 1]
                if not len(ch):
                    continue
                if d == 0 and root_is_leaf:
                    # degree-1 root with a single child: child's down
                    # message is just the root's own leaf term
                    if self.has_seq[self.root]:
                        dn[ch[0]] = self._leaf_loglik_batch(
                            np.array([self.root]), s0, s1)[0]
                    continue
                conv = np.empty((len(ch), 4, w, K))
                tot = np.empty((len(pars), 4, w, K))
                for k in range(K):
                    conv[:, :, :, k] = self._conv_batch(P[ch, k], up[ch])
                    tot[:, :, :, k] = np.add.reduceat(
                        conv[:, :, :, k], starts, axis=0)
                    has_pp = self.parent[pars] >= 0
                    if has_pp.any():
                        pp = pars[has_pp]
                        tot[has_pp, :, :, k] += self._conv_batch(
                            P[pp, k], dn[pp])
                # broadcast each parent's total back onto its children
                seg = np.zeros(len(ch), dtype=np.int64)
                seg[starts[1:]] = 1
                pidx = np.cumsum(seg)
                S = tot[pidx] - conv
                dn[ch] = row_mean_exp_scaled(S) if K > 1 else S[:, :, :, 0]
            self.msg_down[:, :, s0:s1] = dn

    def _evaluate_torch(self, dtype, budget_bytes: int,
                        sites: tuple[int, int] | None, device):
        """The blocked level sweep of evaluate() as f32 tensor ops on one
        torch device: the counterpart of the reference package's
        _evaluate_jax (hmmufotu_tpu/phylo/tree.py:695-835).  A level is
        one set of tensors, not padded fixed-size chunks (those exist
        there only for XLA-CPU compile time).  The message arrays stay
        host numpy of storage ``dtype``; each site block is computed on
        the device and copied back.

        Each parent's sum over its children gathers the level's child
        convolutions into [n_parents, max_degree, K, 4, B], padded with
        0 (a convolution is finite: P > 0 and exp(V - max) has a 1 per
        column), and sums by .sum(1): the same order of summation on
        every run, where index_add_ would sum by float atomics on a
        card."""
        import torch
        from .._cuda import resolve_device
        dev = resolve_device(device)
        N, L = self.num_nodes, self.cs_len
        K = len(self._rates())
        self.msg_up = np.zeros((N, 4, L), dtype=dtype)
        self.msg_down = np.zeros((N, 4, L), dtype=dtype)
        self.msg_read_dtype = None
        if N == 0 or L == 0:
            return
        maxd, lvl, P, seq_leaves, root_is_leaf = self._level_plan()
        f32 = torch.float32
        P = torch.as_tensor(P.astype(np.float32), device=dev)  # [N,K,4,4]
        logpi = torch.as_tensor(np.log(self.model.pi).astype(np.float32),
                                device=dev)
        states = torch.arange(4, dtype=torch.int8, device=dev)

        def index(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)

        # per level: children (sorted by parent), parents, each parent's
        # child slots into the level's children (the pad row n past a
        # parent's degree), each child's parent rank, and the parents
        # that have a parent of their own (their rows, their ids).
        #
        # Block size: the device bytes a block holds at its peak, counted
        # in f32 rows of 4 states (16 bytes) a site: the up and down
        # messages of every node, and one bound of every moment of a
        # level (conv, child_sums, the parents' and the children's
        # collapse, the down sweep's sums; each works in place where it
        # can).  The rest does not grow with the block: P, the index
        # tensors and the largest level's gathered P rows.
        plans = [None] * (maxd + 1)
        rows_max = 5 * len(seq_leaves) // 2 + 1     # leaf rows and masks
        fixed = N * K * 64
        p_rows = 0
        for d in range(1, maxd + 1):
            ch, starts, pars = lvl[d]
            n, npar = len(ch), len(pars)
            deg = np.diff(np.r_[starts, n])
            j = np.arange(int(deg.max()))[None, :]
            slot = np.where(j < deg[:, None], starts[:, None] + j, n)
            has_pp = self.parent[pars] >= 0
            npp = int(has_pp.sum())
            plans[d] = (index(ch), index(pars), index(slot),
                        index(np.repeat(np.arange(npar), deg)),
                        index(np.nonzero(has_pp)[0]), index(pars[has_pp]))
            # child_sums' moment bounds the others: the convolutions,
            # their padded copy, the gather of every parent's slots and
            # its sums ([*, K, 4] rows), beside a conv's or a collapse's
            # input, max, scale and exp or mean ([*, 4] rows)
            rows_max = max(rows_max,
                           (2 * n + 1 + npar * (slot.shape[1] + 1)) * K
                           + 3 * (n + npp))
            fixed += 8 * (3 * n + npar * (slot.shape[1] + 1) + 2 * npp)
            p_rows = max(p_rows, n + npp)
        # a CUDA caching allocator may hand a tensor over 1 MiB a cached
        # block up to 1 MiB larger than it asked for; about ten tensors
        # of a block are alive at its peak
        slack = min(budget_bytes // 8, 10 << 20)
        B = max(32, int((budget_bytes - slack - fixed - p_rows * K * 64)
                        // ((2 * N + rows_max) * 16)))
        B = min(B, L)

        def conv(Pn, V):
            # Pn [n,K,4,4], V [n,4,B] -> [n,K,4,B] log(P @ exp(V)) with
            # per-column max scaling (dot_product_scaled)
            m = V.amax(1, keepdim=True)
            scale = torch.where(torch.isfinite(m), m, 0.0)
            del m
            E = (V - scale).exp_()
            out = torch.einsum("nkij,njb->nkib", Pn, E)
            del E
            return out.log_().add_(scale[:, None])

        def collapse(acc):
            # [m,K,4,B] -> [m,4,B] (row_mean_exp_scaled over rates);
            # overwrites acc
            if K == 1:
                return acc[:, 0]
            m = acc.amax(1, keepdim=True)
            sc = torch.where(torch.isfinite(m), m, 0.0)
            del m
            return acc.sub_(sc).exp_().mean(1).log_().add_(sc[:, 0])

        def child_sums(ch, slot, src):
            # [npar,K,4,B]: each parent's sum of its child convolutions
            c = conv(P[ch], src[ch])
            padded = torch.cat([c, c.new_zeros((1,) + c.shape[1:])])
            return c, padded[slot].sum(1)

        def leaf_rows(ids, s0, s1):
            # [n,4,B] leaf conditional logliks: 0 at the observed base,
            # -inf at the others, log(pi) at gaps (leaf_loglik)
            codes = torch.as_tensor(self.seqs[ids, s0:s1], device=dev)
            eq = codes[:, None, :] == states[None, :, None]
            return torch.where(
                (codes >= 0)[:, None, :],
                torch.where(eq, 0.0, -torch.inf).to(f32),
                logpi[None, :, None].expand(len(ids), 4, s1 - s0))

        root = np.array([self.root])
        leaves = index(seq_leaves)
        lo, hi = (0, L) if sites is None else sites
        for s0 in range(lo, hi, B):
            s1 = min(s0 + B, hi)
            w = s1 - s0
            up = torch.zeros((N, 4, w), dtype=f32, device=dev)
            if len(seq_leaves):
                up[leaves] = leaf_rows(seq_leaves, s0, s1)

            # ---- up sweep -------------------------------------------
            for d in range(maxd, 0, -1):
                ch, pars, slot = plans[d][:3]
                up[pars] = collapse(child_sums(ch, slot, up)[1])
            if root_is_leaf and self.has_seq[self.root]:
                up[self.root] += leaf_rows(root, s0, s1)[0]
            self.msg_up[:, :, s0:s1] = up.cpu().numpy()

            # ---- down sweep -----------------------------------------
            dn = torch.zeros((N, 4, w), dtype=f32, device=dev)
            for d in range(0, maxd):
                ch, pars, slot, prank, pp_rows, pp = plans[d + 1]
                if d == 0 and root_is_leaf:
                    if self.has_seq[self.root]:
                        dn[ch[0]] = leaf_rows(root, s0, s1)[0]
                    continue
                c, tot = child_sums(ch, slot, up)
                # add each parent's own down-message convolution
                if len(pp):
                    tot[pp_rows] += conv(P[pp], dn[pp])
                # children: collapse(tot[parent] - conv(child))
                diff = tot[prank].sub_(c)
                del c, tot
                dn[ch] = collapse(diff)
                del diff
            self.msg_down[:, :, s0:s1] = dn.cpu().numpy()
            # the next block's buffers must not meet these
            del up, dn

    def node_loglik(self, u: int) -> np.ndarray:
        """[4, L] in-message at u combining ALL its neighbors — equals
        the root message after re-rooting at u (reference loglik(node),
        PhyloTreeUnrooted.cpp:315-356)."""
        if u == self.root:
            return self.up_rows(u)
        K = len(self._rates())
        L = self.cs_len
        S = np.zeros((4, L, K))
        for c in self.children_of(u):
            S += self._conv_rates(self.up_rows(c), float(self.brlen[c]))
        S += self._conv_rates(self.down_rows(u), float(self.brlen[u]))
        out = row_mean_exp_scaled(S) if K > 1 else S[:, :, 0]
        if self.is_leaf(u) and self.has_seq[u]:
            out += self.leaf_loglik(self.seqs[u])
        return out

    def tree_loglik(self, start: int = 0, end: int | None = None) -> float:
        """Total loglik = sum_j log(pi . exp(root message))
        (reference treeLoglik, PhyloTreeUnrooted.h:917-951)."""
        if end is None:
            end = self.cs_len - 1
        col = dot_product_scaled_vec(
            self.model.pi, self.up_rows(self.root, slice(start, end + 1)))
        return float(col.sum())

    def infer_seq(self):
        """Fill internal node seqs by per-site argmax of their up-message
        (reference inferSeq, PhyloTreeUnrooted.cpp:1085-1093).  An argmax
        is the same on the stored rows as on their exact widening."""
        for u in range(self.num_nodes):
            if self.has_seq[u]:
                continue
            self.seqs[u] = infer_state(self.msg_up[u])
            self.has_seq[u] = True

    def estimate_num_mutations(self, j: int | None = None) -> np.ndarray:
        """Per-site count of branches whose ML states differ at the two
        ends (reference estimateNumMutations, PhyloTreeUnrooted.cpp:
        1008-1016); vectorized over all sites (on the stored arrays: an
        argmax does not change under an exact widening)."""
        states = self.msg_up.argmax(axis=1)          # [N, L]
        mask = self.parent >= 0
        diff = states[mask] != states[self.parent[mask]]
        counts = diff.sum(axis=0)
        return counts if j is None else counts[j]

    # ----- placement (host-exact f64 reference path) ---------------------
    def estimate_seq(self, seq: np.ndarray, loc: PTLoc,
                     method: str = "unweighted") -> PTPlacement:
        """Fast closed-form placement estimate at a seed branch
        (reference estimateSeq, PhyloTreeUnrooted.cpp:849-877)."""
        u = loc.id
        v = int(self.parent[u])
        c_dist = loc.dist
        pd = p_dist(self.seqs[v], seq, loc.start, loc.end)
        # 0/0 -> nan -> 0.5 (the reference relies on IEEE semantics,
        # PhyloTreeUnrooted.cpp:855-858)
        with np.errstate(invalid="ignore"):
            ratio = float(np.float64(c_dist) / np.float64(c_dist + pd))
        if np.isnan(ratio):
            ratio = 0.5
        w0 = float(self.brlen[u])
        sl = slice(loc.start, loc.end + 1)
        U = self.up_rows(u, sl)
        V = self.down_rows(u, sl)
        Nl = self.leaf_loglik(seq)[:, sl]
        wur = w0 * ratio
        wvr = w0 - wur
        UPr = dot_product_scaled(self.model.Pr(wur), U)
        VPr = dot_product_scaled(self.model.Pr(wvr), V)
        wnr = estimate_branch_length(UPr + VPr, Nl, method)
        NPr = dot_product_scaled(self.model.Pr(wnr), Nl)
        loglik = float(dot_product_scaled_vec(
            self.model.pi, UPr + VPr + NPr).sum())
        a_node = u if ratio <= 0.5 else v
        return PTPlacement(loc.start, loc.end, u, v, a_node,
                           w0, ratio, wnr, loglik)

    def place_seq(self, seq: np.ndarray, place: PTPlacement,
                  max_height: float = np.inf) -> PTPlacement:
        """Accurate placement: joint 3-branch Felsenstein optimization on
        the 2-node copied subtree (reference placeSeq +
        optimizeBranchLength, PhyloTreeUnrooted.cpp:749-954)."""
        u, v = place.c_node, place.p_node
        sl = slice(place.start, place.end + 1)
        U = self.up_rows(u, sl)
        V = self.down_rows(u, sl)
        Nl = self.leaf_loglik(seq)[:, sl]
        w0 = float(self.brlen[u])

        wur, wvr, wnr, loglik = optimize_placement(
            self.model, self._rates(), U, V, Nl, w0,
            place.ratio, place.wnr)

        place.loglik = loglik
        place.wnr = wnr
        # w0 == 0 yields ratio nan, matching the reference (placeSeq
        # divides by the original branch length unguarded, cpp:946)
        with np.errstate(invalid="ignore"):
            place.ratio = np.float64(wur) / np.float64(w0)
        place.height = float(self.heights[u]) + wur
        if place.ratio <= 0.5 or self.heights[v] > max_height:
            place.a_node = u
        else:
            place.a_node = v
        return place

    # ----- model-training data extraction (hmmufotu-train-sm) ------------
    def get_model_training_set(self, method: str = "gojobori",
                               rng: np.random.Generator | None = None
                               ) -> list[np.ndarray]:
        """Goldman 2-seq / Gojobori 3-seq transition counts from tips
        (reference getModelTraningSet*, PhyloTreeUnrooted.cpp:449-486)."""
        if rng is None:
            rng = np.random.default_rng(0)
        data = []
        if method.lower() == "goldman":
            for u in range(self.num_nodes):
                ch = self.children_of(u)
                if self.is_tip(u) and len(ch) >= 2:
                    s1 = self.seqs[ch[0]]
                    s2 = self.seqs[ch[-1]]
                    data.append(SubModel.calc_trans_freq_2seq(s1, s2))
        elif method.lower() == "gojobori":
            for u in range(self.num_nodes):
                ch = self.children_of(u)
                if len(ch) == 2 and (self.is_tip(ch[0])
                                     or self.is_tip(ch[1])):
                    tip, outer = ch
                    if not self.is_tip(tip):
                        tip, outer = outer, tip
                    s0 = self.seqs[self._random_leaf(outer, rng)]
                    tch = self.children_of(tip)
                    s1, s2 = self.seqs[tch[0]], self.seqs[tch[-1]]
                    if p_dist(s0, s1) <= MAX_PDIST \
                            and p_dist(s0, s2) <= MAX_PDIST:
                        data.append(
                            SubModel.calc_trans_freq_3seq(s0, s1, s2))
        else:
            raise ValueError(f"unknown training method {method}")
        return data

    def _random_leaf(self, u: int, rng: np.random.Generator) -> int:
        while not self.is_leaf(u):
            ch = self.children_of(u)
            u = ch[int(rng.integers(len(ch)))]
        return u

    def get_model_freq_est(self) -> np.ndarray:
        f = np.zeros(4)
        for u in range(self.num_nodes):
            if self.is_leaf(u) and self.has_seq[u]:
                f += SubModel.calc_base_freq(self.seqs[u])
        return f

    # ----- posterior consensus (hmmufotu-sum) ------------------------------
    def infer_post_cs(self, u: int, count: np.ndarray,
                      gap: np.ndarray | None = None,
                      alpha: float = 1.0) -> np.ndarray:
        """Posterior consensus of observed counts with the node's
        likelihood profile as Dirichlet prior (reference inferPostCS,
        PhyloTreeUnrooted.cpp:1095-1125)."""
        pri = infer_weight(self.node_loglik(u))
        post = alpha * pri + count
        post = post / post.sum(axis=0, keepdims=True)
        seq = infer_state(post)
        if gap is not None:
            seq = np.where(count.sum(axis=0) >= gap, seq,
                           np.int8(GAP_BASE))
        return seq

    def add_pseudo_leaf(self, subset) -> int:
        """Graft a pseudo-leaf at every non-leaf node in `subset`
        (reference addPseudoLeaf, PhyloTreeUnrooted.cpp:376-412).

        Each internal OTU node u gains a new internal parent r (holding
        u's old branch) and a 0-length leaf that TAKES u's node id (the
        reference swaps ids so OTU ids keep pointing at leaves); u's
        internal role moves to a fresh id.  Likelihood caches are NOT
        extended — use only for tree export afterwards.
        """
        added = 0
        for u in sorted(subset):
            if self.is_leaf(u):
                continue
            old_parent = int(self.parent[u])
            old_len = float(self.brlen[u])
            r = len(self.names)
            m = r + 1
            # r: new internal node taking u's place under old_parent
            self.names.append(self.names[u])
            self.anno.append(self.anno[u])
            # m: u's internal role (children move here)
            self.names.append(self.names[u])
            self.anno.append(self.anno[u])
            self.parent = np.concatenate(
                [self.parent, [old_parent, r]])
            self.brlen = np.concatenate([self.brlen, [old_len, 0.0]])
            self.anno_dist = np.concatenate(
                [self.anno_dist, [self.anno_dist[u]] * 2])
            self.heights = np.concatenate(
                [self.heights, [self.heights[u]] * 2])
            if self.seqs.size:
                self.seqs = np.concatenate(
                    [self.seqs, self.seqs[[u, u]]], axis=0)
                self.has_seq = np.concatenate(
                    [self.has_seq, self.has_seq[[u, u]]])
            self.msa_id = np.concatenate([self.msa_id, [-1, -1]])
            # move u's children to m, then turn u into a 0-length leaf
            self._children = None
            for c in range(len(self.parent) - 2):
                if self.parent[c] == u and c != u:
                    self.parent[c] = m
            if self.root == u:
                self.root = r
                self.parent[r] = -1
                self.brlen[r] = 0.0
            self.parent[u] = r
            self.brlen[u] = 0.0
            self._children = None
            added += 2
        self.msg_up = self.msg_down = None
        return added

    # ----- export / serialization ----------------------------------------
    def to_newick(self, node: int | None = None, subset=None,
                  prefix: str = "") -> str:
        """Newick string of node ids (reference convertToNewickTree,
        PhyloTreeUnrooted.cpp:414-447)."""
        if node is None:
            node = self.root

        def rec(u: int) -> str:
            ch = self.children_of(u)
            if subset is not None:
                ch = ch if any(c in subset for c in ch) else []
            inner = ",".join(rec(c) for c in ch)
            s = f"({inner})" if inner else ""
            s += f"{prefix}{u}"
            if self.parent[u] >= 0:
                s += f":{self.brlen[u]:g}"
            return s

        return rec(node) + ";"

    def to_jplace_tree(self) -> str:
        """jplace tree string with {edgeID} suffixes; edge id = child
        node id (reference toJPlaceTreeStr, PhyloTreeUnrooted.cpp:
        1135-1157 — edge IDs from getEdgeID on child)."""
        def rec(u: int) -> str:
            s = ""
            ch = self.children_of(u)
            if ch:
                s += "(" + ",".join(rec(c) for c in ch) + ")"
            s += str(u)
            if self.parent[u] >= 0:
                if self.brlen[u] > 0:
                    s += f":{self.brlen[u]:g}"
                s += "{%d}" % u
            return s

        return rec(self.root)

    def save(self, path: str):
        meta = {
            "fmt": "hmmufotu-tpu-ptu-v1",
            "cs_len": int(self.cs_len),
            "root": int(self.root),
            "names": self.names,
            "anno": self.anno,
            "model_type": self.model.name if self.model else None,
            "dg_alpha": None if self.dg is None else self.dg.alpha,
            "dg_k": None if self.dg is None else self.dg.k,
        }
        model_txt = ""
        if self.model is not None:
            buf = io.StringIO()
            self.model.write(buf)
            model_txt = buf.getvalue()
        none = np.zeros(0, np.float32)
        write_npz(path, dict(
            meta=np.array([json.dumps(meta)]),
            parent=self.parent, brlen=self.brlen,
            anno_dist=self.anno_dist, heights=self.heights,
            seqs=self.seqs, has_seq=self.has_seq, msa_id=self.msa_id,
            # an f32 array is written as it is, not copied
            msg_up=none if self.msg_up is None
            else np.asarray(self.msg_up, np.float32),
            msg_down=none if self.msg_down is None
            else np.asarray(self.msg_down, np.float32),
            model_txt=np.array([model_txt]),
        ))

    @classmethod
    def _load_topology(cls, z, path: str):
        """(a tree of the file's topology: cs_len, root, names, anno,
        parent, brlen; the file's meta)."""
        tree = cls()
        meta = json.loads(str(z["meta"][0]))
        if not str(meta.get("fmt", "")).startswith("hmmufotu-tpu-ptu-"):
            raise ValueError(
                f"'{path}' is not an hmmufotu-tpu PTU database "
                f"(format tag {meta.get('fmt')!r})")
        tree.cs_len = meta["cs_len"]
        tree.root = meta["root"]
        tree.names = list(meta["names"])
        tree.anno = list(meta["anno"])
        tree.parent = z["parent"]
        tree.brlen = z["brlen"]
        return tree, meta

    @classmethod
    def load_topology(cls, path: str) -> "PTUnrooted":
        """The tree's topology alone (what to_newick and the parent walk
        read): the file's meta, parent and brlen members, no messages."""
        with NpzReader(path) as z:
            return cls._load_topology(z, path)[0]

    @classmethod
    def load(cls, path: str) -> "PTUnrooted":
        with NpzReader(path) as z:
            tree, meta = cls._load_topology(z, path)
            tree.anno_dist = z["anno_dist"]
            tree.heights = z["heights"]
            tree.seqs = z["seqs"]
            tree.has_seq = z["has_seq"]
            tree.msa_id = z["msa_id"]
            # the messages stay f32, as stored; readers widen their rows
            up = z["msg_up"]
            if up.size:
                tree.msg_up, tree.msg_down = up, z["msg_down"]
                tree.msg_read_dtype = np.float64
            if meta["model_type"]:
                tree.model = load_model(io.StringIO(str(z["model_txt"][0])))
            if meta["dg_alpha"] is not None:
                tree.dg = DiscreteGammaModel(meta["dg_alpha"], meta["dg_k"])
        return tree


# --------------------------------------------------------------------------
# branch-length estimation + the 3-branch placement fixed point
# --------------------------------------------------------------------------

def estimate_branch_length(U: np.ndarray, V: np.ndarray,
                           method: str = "unweighted") -> float:
    """Initial pendant-branch estimate from the ML states of the two
    message matrices (reference estimateBranchLength{Unweighted,Weighted},
    PhyloTreeUnrooted.cpp:1018-1052)."""
    b1 = U.argmax(axis=0)
    b2 = V.argmax(axis=0)
    if method == "unweighted":
        return float((b1 != b2).mean())
    if method == "weighted":
        w1 = infer_weight(U)[b1, np.arange(U.shape[1])]
        w2 = infer_weight(V)[b2, np.arange(V.shape[1])]
        ww = w1 * w2
        return float((ww * (b1 != b2)).sum() / ww.sum())
    raise ValueError(f"unknown branch length estimating method '{method}'")


def felsenstein_branch_fixed_point(pi: np.ndarray, U: np.ndarray,
                                   V: np.ndarray, w0: float,
                                   max_len: float) -> float:
    """Single-branch length optimization by Felsenstein's iterative
    algorithm (reference optimizeBranchLength(u,v),
    PhyloTreeUnrooted.cpp:749-798).

    U, V: the two directed messages of the branch, restricted to the
    evaluation window.
    """
    q0 = np.exp(-w0)
    p0 = 1 - q0
    p = p0
    # per-site evidence is loop invariant (the reference recomputes it
    # every iteration, PhyloTreeUnrooted.cpp:764-775)
    logA = dot_product_scaled_vec(pi, U + V)
    logB = dot_product_scaled_vec(pi, U) + dot_product_scaled_vec(pi, V)
    ok = ~(np.isnan(logA) | np.isnan(logB))
    scale = np.maximum(logA, logB)
    eA = np.where(ok, np.exp(logA - scale), 0.0)
    eB = np.where(ok, np.exp(logB - scale), 0.0)
    n = int(ok.sum())
    for _ in range(MAX_ITER):
        if not (0 <= p <= 1):
            break
        num = eB * p0
        frac = np.where(ok, num / (eA * (1 - p0) + num), 0.0)
        p = float(frac.sum()) / n
        q = 1 - p
        if abs(np.log(q) - np.log(1 - p0)) < BRANCH_EPS:
            p0 = p
            break
        p0 = p
    w = -np.log(1 - p0)
    return min(w, max_len)


def optimize_placement(model: SubModel, rates: np.ndarray,
                       U: np.ndarray, V: np.ndarray, Nl: np.ndarray,
                       w0: float, ratio0: float, wnr0: float
                       ) -> tuple[float, float, float, float]:
    """Joint 3-branch optimization on the 4-node star (u, v, n around r)
    (reference optimizeBranchLength(u,v,r,n) + placeSeq,
    PhyloTreeUnrooted.cpp:800-954).

    Returns (wur, wvr, wnr, tree_loglik_over_window).
    """
    pi = model.pi
    K = len(rates)

    def conv(msg: np.ndarray, w: float) -> np.ndarray:
        if K == 1:
            return dot_product_scaled(model.Pr(w * rates[0]), msg)
        S = np.stack([dot_product_scaled(model.Pr(w * r), msg)
                      for r in rates], axis=-1)
        return row_mean_exp_scaled(S)

    def msg_to(a_msg, wa, b_msg, wb):
        """Averaged message out of r toward its third neighbor, combining
        incoming messages a and b per rate category."""
        if K == 1:
            return dot_product_scaled(model.Pr(wa), a_msg) + \
                dot_product_scaled(model.Pr(wb), b_msg)
        S = np.stack(
            [dot_product_scaled(model.Pr(wa * r), a_msg)
             + dot_product_scaled(model.Pr(wb * r), b_msg)
             for r in rates], axis=-1)
        return row_mean_exp_scaled(S)

    wur = wur0 = w0 * ratio0
    wvr = wvr0 = w0 - wur0
    wnr = wnr0_cur = wnr0
    for _ in range(MAX_ITER):
        if not (0 <= wur <= w0):
            break
        # msg(r->n) from U, V; optimize wnr (cap 1)
        Rn = msg_to(U, wur, V, wvr)
        wnr = felsenstein_branch_fixed_point(pi, Rn, Nl, wnr0_cur, 1.0)
        # msg(r->u) from V, N; optimize wur (cap w0)
        Ru = msg_to(V, wvr, Nl, wnr)
        wur = felsenstein_branch_fixed_point(pi, Ru, U, wur0, w0)
        wvr = w0 - wur
        if abs(wur - wur0) < BRANCH_EPS and abs(wnr - wnr0_cur) < BRANCH_EPS:
            break
        wur0, wvr0, wnr0_cur = wur, wvr, wnr

    # root message at r with all three neighbors
    if K == 1:
        S = conv(U, wur) + conv(V, wvr) + conv(Nl, wnr)
    else:
        S = row_mean_exp_scaled(np.stack(
            [dot_product_scaled(model.Pr(wur * r), U)
             + dot_product_scaled(model.Pr(wvr * r), V)
             + dot_product_scaled(model.Pr(wnr * r), Nl)
             for r in rates], axis=-1))
    loglik = float(dot_product_scaled_vec(pi, S).sum())
    return wur, wvr, wnr, loglik
