"""Binary DB interop with the reference HmmUFOtu formats.

Implements byte-level readers AND writers for the reference's three
binary database artifacts (the `.hmm` profile is HMMER3/f text and is
handled by hmm.profile):

- `<db>.msa`  — MSA::save/load          (reference src/MSA.cpp:295-430)
- `<db>.csfm` — CSFMIndex::save/load    (src/CSFMIndex.cpp:176-230),
  including the vendored libcds structures it embeds:
  BitSequenceRRR (src/libcds/src/static/bitsequence/BitSequenceRRR.cpp:
  51-120, 379-434, 15-bit blocks, class/offset coding with the
  table_offset enumeration of TableOffsetRRR.cpp) and WaveletTreeNoptrs
  (src/libcds/src/static/sequence/WaveletTreeNoptrs.cpp:157-285,
  MSB-first level bitmaps over stable prefix partitions)
- `<db>.ptu`  — PTUnrooted::save/load   (src/PhyloTreeUnrooted.cpp:
  496-705; PTUNode at cpp:100-129, PTUBranch at cpp:1054-1082,
  DigitalSeq at src/DigitalSeq.cpp:90-121)

Every file is prefixed by the ProgInfo header (saveProgInfo/
loadProgInfo, src/util/ProgEnv.cpp:24-57: the raw program name plus a
3-int VersionSequence, src/util/VersionSequence.cpp:35-47).

All integers are little-endian (x86 layout the reference uses);
`size_t`/`long` are 8 bytes, `unsigned`/`int`/`uint` 4, bool 1.

Counterpart of hmmufotu_tpu/io/reference_format.py, on this package's modules.
"""

from __future__ import annotations

import io as _io
import struct

import numpy as np

PROG_NAME = "HmmUFOtu"
PROG_VER = (1, 5, 1)            # src/HmmUFOtuEnv.cpp:7-9 "v1.5.1"
SA_SAMPLE_RATE = 4              # CSFMIndex.h:133
RRR_SAMPLE_RATE = 8             # CSFMIndex.h:134
RRR_BLOCK = 15                  # libcds BLOCK_SIZE
RRR02_HDR = 2                   # libcds BitSequence.h:27
WVTREE_NOPTRS_HDR = 3           # libcds Sequence.h:36
MAPPER_NONE_HDR = 2             # libcds Mapper.h:33


# ---------------------------------------------------------------------------
# scalar / string primitives
# ---------------------------------------------------------------------------

def _w(fh, fmt, *vals):
    fh.write(struct.pack("<" + fmt, *vals))


def _r(fh, fmt):
    size = struct.calcsize("<" + fmt)
    vals = struct.unpack("<" + fmt, fh.read(size))
    return vals[0] if len(vals) == 1 else vals


def _w_string(fh, s: bytes | str):
    """StringUtils::saveString with length prefix
    (util/StringUtils.h:213-218)."""
    b = s.encode("latin-1") if isinstance(s, str) else bytes(s)
    _w(fh, "Q", len(b))
    fh.write(b)


def _r_string(fh) -> bytes:
    n = _r(fh, "Q")
    return fh.read(n)


def save_prog_info(fh):
    """saveProgInfo (util/ProgEnv.cpp:24-28): raw name + version."""
    fh.write(PROG_NAME.encode())
    _w(fh, "iii", *PROG_VER)


def load_prog_info(fh):
    """loadProgInfo (util/ProgEnv.cpp:30-57): reject foreign names and
    newer versions."""
    name = fh.read(len(PROG_NAME)).decode("latin-1", "replace")
    if name != PROG_NAME:
        raise ValueError(f"not a valid {PROG_NAME} database file "
                         f"(got program name {name!r})")
    ver = _r(fh, "iii")
    if tuple(ver) > PROG_VER:
        raise ValueError(f"database written by newer {PROG_NAME} "
                         f"v{ver[0]}.{ver[1]}.{ver[2]}")
    return ver


# ---------------------------------------------------------------------------
# libcds bit plumbing: flat LSB-first bitstreams inside uint32 words
# (libcdsBasics.h get/set_var_field semantics == a little-endian-bit
# flat stream, so numpy packbits(bitorder='little') reproduces them)
# ---------------------------------------------------------------------------

def _bits_to_words(bits: np.ndarray) -> np.ndarray:
    """bool[*] -> uint32 words, LSB-first."""
    n_words = max(1, (len(bits) + 31) // 32)
    padded = np.zeros(n_words * 32, dtype=np.uint8)
    padded[: len(bits)] = bits.astype(np.uint8)
    by = np.packbits(padded, bitorder="little")
    return by.view(np.uint32)


def _words_to_bits(words: np.ndarray, n_bits: int) -> np.ndarray:
    by = np.asarray(words, dtype="<u4").view(np.uint8)
    bits = np.unpackbits(by, bitorder="little")
    return bits[:n_bits].astype(bool)


def _bits(n: int) -> int:
    """libcds bits(n): number of bits to represent n
    (libcdsBasics.h:112-117)."""
    b = 0
    while n:
        b += 1
        n >>= 1
    return b


def _uint_len(e: int, n: int) -> int:
    """libcds uint_len: uint32 words needed for e fields of n bits."""
    total = e * n
    return total // 32 + (1 if total % 32 else 0)


# ----- table_offset (TableOffsetRRR.cpp genera/generaClase order) ---------

class _RRRTables:
    """Class/offset enumeration for 15-bit blocks: within each popcount
    class, blocks are ranked in the order generaClase emits them (set
    bits chosen at ascending positions, lowest position outermost)."""

    def __init__(self, u: int = RRR_BLOCK):
        self.u = u
        order: list[int] = []
        class_of = np.zeros(1 << u, dtype=np.int8)
        offset_of = np.zeros(1 << u, dtype=np.int32)
        by_class: list[list[int]] = [[] for _ in range(u + 1)]

        def gen(clase, puestos, pos_ini, generado):
            if clase == puestos:
                by_class[clase].append(generado)
                return
            for i in range(pos_ini, u):
                gen(clase, puestos + 1, i + 1, generado | (1 << i))

        for c in range(u + 1):
            gen(c, 0, 0, 0)
            for off, v in enumerate(by_class[c]):
                class_of[v] = c
                offset_of[v] = off
        self.class_of = class_of
        self.offset_of = offset_of
        self.by_class = [np.array(v, dtype=np.uint32) for v in by_class]
        # log2binomial per the libcds binomial table: bits(C(u,k) - 1)
        from math import comb
        self.log2binomial = np.array(
            [_bits(comb(u, k) - 1) for k in range(u + 1)], dtype=np.int64)


_RRR = None


def _rrr_tables() -> _RRRTables:
    global _RRR
    if _RRR is None:
        _RRR = _RRRTables()
    return _RRR


# ----- BitSequenceRRR -------------------------------------------------------

def rrr_save(fh, bits: np.ndarray, sample_rate: int = RRR_SAMPLE_RATE):
    """Encode + save one BitSequenceRRR
    (BitSequenceRRR.cpp:51-87 build, 379-402 save)."""
    T = _rrr_tables()
    bits = np.asarray(bits, dtype=bool)
    n = len(bits)
    c_len = n // RRR_BLOCK + (1 if n % RRR_BLOCK else 0)
    padded = np.zeros(c_len * RRR_BLOCK, dtype=np.uint8)
    padded[:n] = bits
    blocks = padded.reshape(c_len, RRR_BLOCK)
    weights = (1 << np.arange(RRR_BLOCK, dtype=np.uint32))
    values = (blocks.astype(np.uint32) * weights[None, :]).sum(axis=1)
    classes = T.class_of[values].astype(np.uint32)
    ones = int(classes.sum())
    widths = T.log2binomial[classes]
    offsets = T.offset_of[values]
    o_bits_len = int(widths.sum())

    # O stream: concatenated offsets, each LSB-first in its width
    o_stream = np.zeros(o_bits_len, dtype=bool)
    pos = np.concatenate([[0], np.cumsum(widths)[:-1]])
    for i in range(c_len):
        w = int(widths[i])
        if w:
            v = int(offsets[i])
            p = int(pos[i])
            for b in range(w):
                o_stream[p + b] = (v >> b) & 1

    c_field_bits = _bits(RRR_BLOCK)            # 4
    c_stream = np.zeros(c_len * c_field_bits, dtype=bool)
    for b in range(c_field_bits):
        c_stream[b::c_field_bits] = (classes >> b) & 1

    _w(fh, "I", RRR02_HDR)
    _w(fh, "QQ", n, ones)
    _w(fh, "IIIII", c_len, c_field_bits, max(1, _uint_len(1, o_bits_len)),
       o_bits_len, sample_rate)
    c_words = _bits_to_words(c_stream)[: _uint_len(c_len, c_field_bits)]
    fh.write(c_words.astype("<u4").tobytes())
    o_words = _bits_to_words(o_stream)[: max(1, _uint_len(1, o_bits_len))]
    fh.write(o_words.astype("<u4").tobytes())


def rrr_load(fh) -> np.ndarray:
    """Load + decode one BitSequenceRRR -> bool array
    (BitSequenceRRR.cpp:404-434 load; sampling is rebuilt, not stored)."""
    T = _rrr_tables()
    hdr = _r(fh, "I")
    if hdr != RRR02_HDR:
        raise ValueError(f"bad RRR header {hdr}")
    n, ones = _r(fh, "QQ")
    c_len, c_field_bits, o_len, o_bits_len, _sr = _r(fh, "IIIII")
    c_words = np.frombuffer(
        fh.read(4 * _uint_len(c_len, c_field_bits)), dtype="<u4")
    o_words = np.frombuffer(fh.read(4 * o_len), dtype="<u4")
    c_stream = _words_to_bits(c_words, c_len * c_field_bits)
    classes = np.zeros(c_len, dtype=np.int64)
    for b in range(c_field_bits):
        classes |= c_stream[b::c_field_bits].astype(np.int64) << b
    widths = T.log2binomial[classes]
    o_stream = _words_to_bits(o_words, o_bits_len)
    pos = np.concatenate([[0], np.cumsum(widths)[:-1]])
    values = np.zeros(c_len, dtype=np.uint32)
    for i in range(c_len):
        w = int(widths[i])
        off = 0
        p = int(pos[i])
        for b in range(w):
            off |= int(o_stream[p + b]) << b
        values[i] = T.by_class[classes[i]][off]
    blocks = ((values[:, None] >> np.arange(RRR_BLOCK)[None, :]) & 1)
    bits = blocks.reshape(-1)[:n].astype(bool)
    assert int(bits.sum()) == ones
    return bits


# ----- WaveletTreeNoptrs ----------------------------------------------------

def wt_save(fh, symbols: np.ndarray, sample_rate: int = RRR_SAMPLE_RATE):
    """Encode + save a WaveletTreeNoptrs over small uint symbols
    (WaveletTreeNoptrs.cpp:157-240 width-ctor + 245-257 save):
    MapperNone, height=bits(max_v) MSB-first level bitmaps, symbols
    with zero count in 1..max_v get one fake occurrence appended."""
    symbols = np.asarray(symbols, dtype=np.uint32)
    n = len(symbols)
    max_v = int(symbols.max())
    height = _bits(max_v)
    counts = np.bincount(symbols, minlength=max_v + 2)
    # reference appends one fake occurrence for every ABSENT value in
    # 0..max_v (OCC[i]==0 check for i in 1..max_v+1)
    fakes = [v for v in range(0, max_v + 1) if counts[v] == 0]
    sym = np.concatenate(
        [symbols, np.array(fakes, dtype=np.uint32)]) if fakes else symbols
    new_n = len(sym)
    occ_counts = np.bincount(sym, minlength=max_v + 2)[: max_v + 2]
    occ = np.zeros(max_v + 2, dtype=np.uint32)
    occ[1:] = np.cumsum(occ_counts[: max_v + 1])

    _w(fh, "I", WVTREE_NOPTRS_HDR)
    _w(fh, "QQ", new_n, n)
    _w(fh, "II", max_v, height)
    _w(fh, "I", MAPPER_NONE_HDR)
    cur = sym
    for level in range(height):
        bit = (cur >> (height - level - 1)) & 1
        rrr_save(fh, bit.astype(bool), sample_rate)
        if level + 1 < height:
            # build_level recurses per segment: the next level's order
            # is a stable sort by the full (level+1)-bit prefix
            prefix = cur >> (height - level - 1)
            cur = cur[np.argsort(prefix, kind="stable")]
    fh.write(occ.astype("<u4").tobytes())


def wt_load(fh) -> np.ndarray:
    """Load + decode a WaveletTreeNoptrs -> uint8 symbol array of the
    original length (fake appended symbols dropped)."""
    hdr = _r(fh, "I")
    if hdr != WVTREE_NOPTRS_HDR:
        raise ValueError(f"bad WaveletTree header {hdr}")
    new_n, length = _r(fh, "QQ")
    max_v, height = _r(fh, "II")
    m_hdr = _r(fh, "I")
    if m_hdr != MAPPER_NONE_HDR:
        raise ValueError(f"unsupported mapper {m_hdr}")
    levels = [rrr_load(fh) for _ in range(height)]
    occ = np.frombuffer(fh.read(4 * (max_v + 2)), dtype="<u4")

    # vectorized access() walk over every position at once
    # (WaveletTreeNoptrs.cpp:301-322)
    pos = np.arange(new_n, dtype=np.int64)
    ret = np.zeros(new_n, dtype=np.uint32)
    start = np.zeros(new_n, dtype=np.int64)
    for level in range(height):
        bm = levels[level]
        csum = np.concatenate([[0], np.cumsum(bm)])   # rank1(i-1)=csum[i]
        before = np.where(start > 0, csum[start], 0)  # rank1(start-1)
        bit = bm[pos]
        rank1 = csum[pos + 1]
        ret_new = ret | (np.uint32(1) << (height - level - 1))
        # speculative ret_new can exceed max_v for positions whose real
        # bit is 0 (discarded by the where below) — clip the lookup
        start_r = occ[np.minimum(ret_new, len(occ) - 1)].astype(np.int64)
        pos_r = (rank1 - 1 - before) + start_r
        rank0 = (pos + 1) - rank1
        pos_l = rank0 - 1 + before
        ret = np.where(bit, ret_new, ret)
        start = np.where(bit, start_r, start)
        pos = np.where(bit, pos_r, pos_l)
    return ret[:length].astype(np.uint8)


# ---------------------------------------------------------------------------
# .msa (reference MSA.cpp:295-430)
# ---------------------------------------------------------------------------

def save_reference_msa(msa, path: str):
    from ..msa import MSA  # noqa: F401  (typing only)
    with open(path, "wb") as fh:
        save_prog_info(fh)
        _w_string(fh, msa.abc.name)
        _w_string(fh, msa.name)
        N, L = msa.num_seq, msa.cs_len
        _w(fh, "II", N, L)
        _w_string(fh, msa.get_cs())
        _w(fh, "?", bool(msa.is_pruned))
        for nm in msa.names:
            _w_string(fh, nm)
        _w_string(fh, msa.chars.tobytes())           # concatMSA
        fh.write(msa.start_idx.astype("<i4").tobytes())
        fh.write(msa.end_idx.astype("<i4").tobytes())
        fh.write(msa.len_idx.astype("<i4").tobytes())
        # Eigen matrices serialize column-major; resCount is 4 x csLen
        fh.write(np.asarray(msa.res_count, dtype="<i4")
                 .T.reshape(-1).tobytes())
        fh.write(msa.gap_count.astype("<i4").tobytes())
        fh.write(msa.seq_weight.astype("<f8").tobytes())
        fh.write(np.asarray(msa.res_wcount, dtype="<f8")
                 .T.reshape(-1).tobytes())
        fh.write(msa.gap_wcount.astype("<f8").tobytes())


def load_reference_msa(path: str):
    from ..msa import MSA
    from ..alphabet import get_alphabet
    with open(path, "rb") as fh:
        load_prog_info(fh)
        abc = get_alphabet(_r_string(fh).decode())
        name = _r_string(fh).decode()
        N, L = _r(fh, "II")
        cs = _r_string(fh).decode()
        is_pruned = _r(fh, "?")
        names = [_r_string(fh).decode() for _ in range(N)]
        concat = _r_string(fh)
        chars = np.frombuffer(concat, dtype=np.uint8).reshape(N, L)
        # remaining arrays are recomputable; consume for stream position
        fh.read(4 * N * 3)                       # start/end/len idx
        fh.read(4 * 4 * L + 4 * L)               # resCount + gapCount
        fh.read(8 * N)                           # seqWeight
        fh.read(8 * 4 * L + 8 * L)               # resWCount + gapWCount
        msa = MSA.from_arrays(names, chars.copy(), abc, name=name)
        msa.is_pruned = is_pruned
        del cs  # counts/weights/CS are recomputed from the chars
        return msa


# ---------------------------------------------------------------------------
# .csfm (reference CSFMIndex.cpp:176-230)
# ---------------------------------------------------------------------------

def save_reference_csfm(csfm, path: str):
    with open(path, "wb") as fh:
        save_prog_info(fh)
        _w_string(fh, csfm.abc.name)
        fh.write(csfm.gap_ch.encode("latin-1"))
        _w(fh, "H", csfm.cs_len)
        _w(fh, "i", csfm.concat_len)
        C = np.zeros(256, dtype="<i4")
        C[: len(csfm.C) - 1] = csfm.C[:-1]       # C[0..size+1] cumulative
        C[len(csfm.C) - 1] = csfm.C[-1]
        fh.write(C.tobytes())
        _w_string(fh, csfm.cs_seq)
        fh.write(np.asarray(csfm.cs_identity, dtype="<f8").tobytes())
        fh.write(csfm.concat2cs.astype("<u2").tobytes())
        # the reference writes concatLen/4 sampled values though
        # floor(concatLen/4)+1 exist — the last (in SA-row order) is
        # dropped (CSFMIndex.cpp:192 vs the N/4+1 allocation at :338);
        # the loader below reconstructs it arithmetically
        n_sample = csfm.concat_len // SA_SAMPLE_RATE
        sv = np.asarray(csfm.sampled_vals[:n_sample], dtype="<u4")
        fh.write(sv.tobytes())
        # saIdx: bitvector marking sampled SA rows (total + 1 rows)
        total = csfm.concat_len + 1
        mask = np.zeros(total, dtype=bool)
        mask[np.asarray(csfm.sampled_rows)] = True
        rrr_save(fh, mask)
        # BWT wavelet tree over total symbols
        wt_save(fh, np.asarray(csfm.bwt, dtype=np.uint32))


def load_reference_csfm(path: str):
    from ..index.csfm import CSFMIndex
    from ..alphabet import get_alphabet
    with open(path, "rb") as fh:
        load_prog_info(fh)
        abc = get_alphabet(_r_string(fh).decode())
        gap_ch = fh.read(1).decode("latin-1")
        cs_len = _r(fh, "H")
        concat_len = _r(fh, "i")
        C = np.frombuffer(fh.read(4 * 256), dtype="<i4")
        cs_seq = _r_string(fh).decode("latin-1")
        cs_identity = np.frombuffer(fh.read(8 * (cs_len + 1)), dtype="<f8")
        concat2cs = np.frombuffer(fh.read(2 * (concat_len + 1)),
                                  dtype="<u2")
        n_sample = concat_len // SA_SAMPLE_RATE
        sampled_vals = np.frombuffer(fh.read(4 * n_sample),
                                     dtype="<u4").astype(np.int64)
        sa_mask = rrr_load(fh)
        bwt = wt_load(fh).astype(np.int8)
    n_rows = int(sa_mask.sum())
    if n_rows == n_sample + 1:
        # reconstruct the value the reference's save drops: sampled
        # values are exactly the multiples of SA_SAMPLE_RATE in
        # [0, concat_len], so the missing one is the set difference
        all_sum = sum(range(0, concat_len + 1, SA_SAMPLE_RATE))
        missing = all_sum - int(sampled_vals.sum())
        sampled_vals = np.concatenate([sampled_vals, [missing]])

    idx = CSFMIndex()
    idx.abc = abc
    idx.gap_ch = gap_ch
    idx.cs_len = int(cs_len)
    idx.concat_len = int(concat_len)
    idx.cs_seq = cs_seq
    idx.cs_identity = np.asarray(cs_identity, dtype=np.float64)
    idx.concat2cs = np.asarray(concat2cs, dtype=np.uint16)
    # production C = [0, cumsum(bincount(concat))]; recompute from the
    # decoded BWT (a permutation of the concat) — the file's 256-slot C
    # only covers byte values 0..abc.size+1
    counts = np.bincount(bwt + 0, minlength=abc.size + 2)
    idx.C = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    assert (idx.C[: abc.size + 2] ==
            np.asarray(C[: abc.size + 2], dtype=np.int64)).all()
    idx.sampled_rows = np.nonzero(sa_mask)[0].astype(np.int64)
    idx.sampled_vals = np.asarray(sampled_vals, dtype=np.int64)
    idx.bwt = bwt            # setter builds the compact rank structures
    return idx


# ---------------------------------------------------------------------------
# .ptu (reference PhyloTreeUnrooted.cpp:496-705)
# ---------------------------------------------------------------------------

def _save_digital_seq(fh, codes: np.ndarray, name: str, abc_name="DNA"):
    """DigitalSeq::save with alphabet (DigitalSeq.cpp:90-103)."""
    _w(fh, "?", True)
    _w_string(fh, abc_name)
    _w_string(fh, name)
    _w_string(fh, np.asarray(codes, dtype=np.int8).tobytes())


def _load_digital_seq(fh):
    flag = _r(fh, "?")
    if flag:
        _r_string(fh)                            # alphabet name
    name = _r_string(fh).decode()
    codes = np.frombuffer(_r_string(fh), dtype=np.int8)
    return name, codes


def save_reference_ptu(tree, path: str):
    """PTUnrooted::save transcription; messages come from the
    flattened msg_up/msg_down arrays (node2branch[u][parent] == msg_up,
    node2branch[parent][u] == msg_down)."""
    N = tree.num_nodes
    L = tree.cs_len
    with open(path, "wb") as fh:
        save_prog_info(fh)
        _w(fh, "Q", N)
        _w(fh, "i", L)
        for u in range(N):
            _w(fh, "q", u)
            _w_string(fh, tree.names[u])
            _save_digital_seq(
                fh, tree.seqs[u] if tree.seqs.size else
                np.zeros(0, np.int8), tree.names[u])
            _w_string(fh, tree.anno[u])
            _w(fh, "d", float(tree.anno_dist[u]))
        # directed edges: for every node u, (u -> each child) and
        # (u -> parent); loglik(u->v) with v=parent(u) is msg_up[u],
        # loglik(parent->u) is msg_down[u]
        edges = []
        for u in range(N):
            for c in tree.children_of(u):
                edges.append((u, c))
            if tree.parent[u] >= 0:
                edges.append((u, int(tree.parent[u])))
        _w(fh, "Q", len(edges))
        for u, v in edges:
            _w(fh, "qq", u, v)
            is_parent = tree.parent[v] == u        # u is v's parent
            _w(fh, "?", bool(is_parent))
            if is_parent:                          # u -> child v
                length = float(tree.brlen[v])
                msg = tree.msg_down[v]
            else:                                  # u -> its parent v
                length = float(tree.brlen[u])
                msg = tree.msg_up[u]
            _w(fh, "d", length)
            _w(fh, "Q", 4 * L)
            # f32 messages (a loaded DB's) widen to f8 exactly
            fh.write(np.asarray(msg, dtype="<f8").T.reshape(-1).tobytes())
        # root + root in-message
        _w(fh, "q", int(tree.root))
        fh.write(np.asarray(tree.msg_up[tree.root], dtype="<f8")
                 .T.reshape(-1).tobytes())
        # node heights
        for u in range(N):
            _w(fh, "q", u)
            _w(fh, "d", float(tree.heights[u]))
        # MSA index
        pairs = [(int(tree.msa_id[u]), u) for u in range(N)
                 if tree.msa_id[u] >= 0]
        pairs.sort()
        _w(fh, "I", len(pairs))
        for msa_id, u in pairs:
            _w(fh, "I", msa_id)
            _w(fh, "q", u)
        # model (text section: type line + model.write body)
        txt = _io.StringIO()
        txt.write(tree.model.name + "\n")
        tree.model.write(txt)
        fh.write(txt.getvalue().encode())
        # DG model
        _w(fh, "?", tree.dg is not None)
        if tree.dg is not None:
            _w(fh, "i", int(tree.dg.k))
            _w(fh, "d", float(tree.dg.alpha))
            fh.write(np.asarray(tree.dg.b, dtype="<f8").tobytes())
            fh.write(np.asarray(tree.dg.r, dtype="<f8").tobytes())


def load_reference_ptu(path: str):
    from ..phylo.tree import PTUnrooted
    from ..phylo.models import load_model
    from ..phylo.dgamma import DiscreteGammaModel
    tree = PTUnrooted()
    with open(path, "rb") as fh:
        load_prog_info(fh)
        N = _r(fh, "Q")
        L = _r(fh, "i")
        tree.cs_len = L
        names = []
        annos = []
        anno_dist = np.zeros(N)
        seqs = np.full((N, L), -128, dtype=np.int8)
        has_seq = np.zeros(N, dtype=bool)
        for i in range(N):
            nid = _r(fh, "q")
            assert nid == i, "node ids must be dense and ordered"
            names.append(_r_string(fh).decode())
            _, codes = _load_digital_seq(fh)
            if len(codes) == L:
                seqs[i] = codes
                has_seq[i] = True
            annos.append(_r_string(fh).decode())
            anno_dist[i] = _r(fh, "d")
        n_edges = _r(fh, "Q")
        parent = np.full(N, -1, dtype=np.int64)
        brlen = np.zeros(N)
        msg_up = np.zeros((N, 4, L))
        msg_down = np.zeros((N, 4, L))
        for _ in range(n_edges):
            u, v = _r(fh, "qq")
            is_parent = _r(fh, "?")
            length = _r(fh, "d")
            n_val = _r(fh, "Q")
            assert n_val == 4 * L
            msg = np.frombuffer(fh.read(8 * n_val), dtype="<f8") \
                .reshape(L, 4).T
            if is_parent:          # u is v's parent: edge u->v
                parent[v] = u
                brlen[v] = length
                msg_down[v] = msg
            else:                  # edge u->parent
                brlen[u] = length
                msg_up[u] = msg
        root = _r(fh, "q")
        root_msg = np.frombuffer(fh.read(8 * 4 * L), dtype="<f8") \
            .reshape(L, 4).T
        msg_up[root] = root_msg
        heights = np.zeros(N)
        for _ in range(N):
            nid = _r(fh, "q")
            heights[nid] = _r(fh, "d")
        n_msa = _r(fh, "I")
        msa_id = np.full(N, -1, dtype=np.int64)
        for _ in range(n_msa):
            mid = _r(fh, "I")
            nid = _r(fh, "q")
            msa_id[nid] = mid
        # model text: type line + "# DNA Substitution Model" body
        type_line = _read_text_line(fh)
        body = []
        body.append(_read_text_line(fh))         # comment header
        body.append(_read_text_line(fh))         # Type:
        if type_line == "JC69":
            n_more = 0
        elif type_line == "K80":
            n_more = 1                           # kappa line
        elif type_line == "F81":
            n_more = 2                           # pi + beta
        elif type_line == "HKY85":
            n_more = 2                           # pi + kappa/beta
        elif type_line == "TN93":
            n_more = 2                           # pi + kr/ky/beta
        elif type_line == "GTR":
            n_more = 11                          # pi + R: + 4 + Q: + 4
        else:
            raise ValueError(f"unknown model type {type_line!r}")
        for _ in range(n_more):
            body.append(_read_text_line(fh))
        model = load_model(_io.StringIO("\n".join(body) + "\n"))
        dg_set = _r(fh, "?")
        dg = None
        if dg_set:
            k = _r(fh, "i")
            alpha = _r(fh, "d")
            fh.read(8 * (k + 1))                 # breaks (recomputed)
            fh.read(8 * k)                       # rates (recomputed)
            dg = DiscreteGammaModel(alpha, k)

    tree.names = names
    tree.anno = annos
    tree.anno_dist = anno_dist
    tree.heights = heights
    tree.parent = parent
    tree.brlen = brlen
    tree.root = int(root)
    tree.seqs = seqs
    tree.has_seq = has_seq
    tree.msa_id = msa_id
    tree.msg_up = msg_up
    tree.msg_down = msg_down
    tree.model = model
    tree.dg = dg
    return tree


def _read_text_line(fh) -> str:
    """Read one '\\n'-terminated text line from a binary stream."""
    out = bytearray()
    while True:
        b = fh.read(1)
        if not b or b == b"\n":
            break
        out.extend(b)
    return out.decode()


# ---------------------------------------------------------------------------
# whole-DB convenience
# ---------------------------------------------------------------------------

def save_reference_db(db, prefix: str):
    """Write a production Database in the reference's 4-file binary
    layout: <prefix>.msa/.csfm/.hmm/.ptu (hmm as HMMER3/f text like
    hmmufotu-build.cpp:487-494)."""
    save_reference_msa(db.msa, prefix + ".msa")
    save_reference_csfm(db.csfm, prefix + ".csfm")
    db.hmm.to_hmmer_file(prefix + ".hmm")
    save_reference_ptu(db.ptu, prefix + ".ptu")


def load_reference_db(prefix: str):
    """Read a reference-layout 4-file DB into production objects."""
    from ..db import Database
    from ..hmm import ProfileHMM
    msa = load_reference_msa(prefix + ".msa")
    csfm = load_reference_csfm(prefix + ".csfm")
    hmm = ProfileHMM.from_hmmer_file(prefix + ".hmm")
    ptu = load_reference_ptu(prefix + ".ptu")
    return Database(msa, csfm, hmm, ptu)
