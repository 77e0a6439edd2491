"""The DB's npz files (.msa.npz, .csfm.npz, .ptu.npz), deflated and
inflated on every host core.

write_npz writes the file np.savez_compressed writes: one .npy member an
array, ZIP_DEFLATED, zip64 local headers.  Each member's stream is cut
into chunks: the .npy header, then CHUNK_BYTES of the array's bytes a
chunk.  Each chunk is raw deflate of its own (no shared history), ended
by Z_FULL_FLUSH, the last by Z_FINISH, so the chunks laid end to end are
one ordinary deflate stream, which np.load, zipfile and the reference
package read as they read any npz.  The chunks are deflated on a thread
pool (zlib releases the GIL) and written in order; the member's central
directory entry carries the chunk sizes in an extra field of its own
(CHUNK_TABLE_ID), which other readers skip.  The chunk size is a
constant, so a file's bytes do not depend on how many threads wrote it.

NpzReader reads such a member by inflating its chunks on a thread pool,
each straight into its slice of one array of the header's dtype, shape
and order, and checks the member's CRC-32 (the chunks' CRCs combined).
A member without a chunk table (a file the reference package or an
earlier version of this one wrote) is read through np.load, as before.
"""

from __future__ import annotations

import functools
import io
import math
import os
import struct
import tokenize
import zipfile
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from numpy.lib import format as npy_format

# zlib level of every member: level 1 deflates the messages well faster
# than np.savez_compressed's level 6 for a few percent more bytes
# (PERF.md section 5)
ZLIB_LEVEL = 1
# bytes of the array a chunk holds: 4 MiB gives the 14.4 GB message
# member of a 149,999-node tree 3,433 chunks, a table of 13.7 KB
CHUNK_BYTES = 4 << 20
# the extra field of a member's central directory entry holding its
# chunk table: version, chunk bytes, then each chunk's deflated size
CHUNK_TABLE_ID = 0x6368
_TABLE_HEAD = struct.Struct("<BQ")
TABLE_VERSION = 1
# zipfile's layout constants (zipfile/__init__.py)
_LOCAL = struct.Struct("<4s2B4HL2L2H")
_CENTRAL = struct.Struct("<4s4B4HL2L5H2L")
_END = struct.Struct("<4s4H2LH")
_END64 = struct.Struct("<4sQ2H2L4Q")
_END64_LOC = struct.Struct("<4sLQL")
_ZIP64_LIMIT = (1 << 31) - 1
_COUNT_LIMIT = (1 << 16) - 1
_ZIP64_VERSION = 45
_UNIX = 3
_ATTR = 0o600 << 16
_DOS_DATE = (0 << 9) | (1 << 5) | 1       # 1980-01-01 00:00:00
# an extra field holds 65,535 bytes: the zip64 field's 28, the table's
# own 13, then 4 a chunk (16,373 chunks: a member of 63.9 GiB)
_MAX_TABLE = 0xFFFF - 28 - 4 - _TABLE_HEAD.size
# the most a chunk-0 .npy header may inflate to (write_npz's are a few
# hundred bytes)
_MAX_HEADER = 1 << 20


def host_threads() -> int:
    """The threads the writer and the reader use: every core this
    process may run on."""
    return len(os.sched_getaffinity(0))


def _array_bytes(arr: np.ndarray):
    """(the .npy header of arr, a flat uint8 view of its data in the
    order the header names).  An array neither C- nor F-contiguous is
    copied, as np.save writes it in C order."""
    if not (arr.flags.c_contiguous or arr.flags.f_contiguous):
        arr = np.ascontiguousarray(arr)
    head = npy_format.header_data_from_array_1_0(arr)
    buf = io.BytesIO()
    try:
        npy_format.write_array_header_1_0(buf, head)
    except ValueError:                  # a header past 65,535 bytes
        buf = io.BytesIO()
        npy_format.write_array_header_2_0(buf, head)
    data = arr.T if head["fortran_order"] else arr
    return buf.getvalue(), data.reshape(-1).view(np.uint8)


def _deflate(piece, last: bool):
    c = zlib.compressobj(ZLIB_LEVEL, zlib.DEFLATED, -zlib.MAX_WBITS)
    out = c.compress(piece) + c.flush(zlib.Z_FINISH if last
                                      else zlib.Z_FULL_FLUSH)
    return out, zlib.crc32(piece)


@functools.lru_cache(maxsize=16)
def _zero_shift(n: int):
    """The CRC-32 register's map over n zero bytes, as 32 columns:
    crc32(A + B) == shift(crc32(A)) ^ crc32(B) for len(B) == n."""
    zeros = bytes(n)
    base = zlib.crc32(zeros, 0)
    cols = [zlib.crc32(zeros, 1 << i) ^ base for i in range(32)]

    def shift(crc: int) -> int:
        out = 0
        for i in range(32):
            if crc >> i & 1:
                out ^= cols[i]
        return out
    return shift


def _crc_join(crc_a: int, crc_b: int, n_b: int) -> int:
    """crc32(A + B) from crc32(A), crc32(B) and len(B)."""
    return _zero_shift(n_b)(crc_a) ^ crc_b


def _local_header(name: bytes, crc: int, size: int, csize: int) -> bytes:
    extra = struct.pack("<HHQQ", 1, 16, size, csize)
    return _LOCAL.pack(b"PK\003\004", _ZIP64_VERSION, 0, 0,
                       zipfile.ZIP_DEFLATED, 0, _DOS_DATE, crc, 0xFFFFFFFF,
                       0xFFFFFFFF, len(name), len(extra)) + name + extra


def _central_header(name: bytes, crc: int, size: int, csize: int,
                    offset: int, table: bytes) -> bytes:
    big = []
    if size > _ZIP64_LIMIT or csize > _ZIP64_LIMIT:
        big += [size, csize]
        size = csize = 0xFFFFFFFF
    if offset > _ZIP64_LIMIT:
        big.append(offset)
        offset = 0xFFFFFFFF
    extra = (struct.pack("<HH" + "Q" * len(big), 1, 8 * len(big), *big)
             if big else b"") + table
    return _CENTRAL.pack(b"PK\001\002", _ZIP64_VERSION, _UNIX,
                         _ZIP64_VERSION, 0, 0, zipfile.ZIP_DEFLATED, 0,
                         _DOS_DATE, crc, csize, size, len(name), len(extra),
                         0, 0, 0, _ATTR, offset) + name + extra


def _write_member(fh, pool, threads: int, name: str, arr) -> bytes:
    """Write one member at the file's end; returns its central header."""
    bname = name.encode()
    arr = np.asanyarray(arr)
    if arr.dtype.hasobject:
        raise ValueError(f"member '{name}' holds objects")
    head, data = _array_bytes(arr)
    view = memoryview(data)
    n = len(view)
    if 4 * (1 + -(-n // CHUNK_BYTES)) > _MAX_TABLE:
        raise ValueError(f"member '{name}' has too many chunks for its "
                         f"chunk table")
    offset = fh.tell()
    fh.write(_local_header(bname, 0, 0, 0))
    pieces = [memoryview(head)] + [view[i:i + CHUNK_BYTES]
                                   for i in range(0, n, CHUNK_BYTES)]
    crc, sizes, pending = 0, [], deque()

    def drain():
        nonlocal crc
        job, length = pending.popleft()
        out, piece_crc = job.result()
        fh.write(out)
        sizes.append(len(out))
        crc = _crc_join(crc, piece_crc, length)

    # at most 2 * threads deflated chunks wait to be written
    for k, piece in enumerate(pieces):
        if len(pending) >= 2 * threads:
            drain()
        pending.append((pool.submit(_deflate, piece, k == len(pieces) - 1),
                        len(piece)))
    while pending:
        drain()
    size, csize = len(head) + n, sum(sizes)
    end = fh.tell()
    fh.seek(offset)
    fh.write(_local_header(bname, crc, size, csize))
    fh.seek(end)
    table = _TABLE_HEAD.pack(TABLE_VERSION, CHUNK_BYTES) + struct.pack(
        f"<{len(sizes)}I", *sizes)
    return _central_header(bname, crc, size, csize, offset,
                           struct.pack("<HH", CHUNK_TABLE_ID, len(table))
                           + table)


def write_npz(path: str, arrays: dict, threads: int | None = None) -> str:
    """Write arrays (name -> array) as path (".npz" appended where it is
    missing, as np.savez does) on `threads` threads (host_threads() by
    default); returns the path written."""
    if not path.endswith(".npz"):
        path += ".npz"
    threads = threads or host_threads()
    central = []
    with open(path, "wb") as fh, ThreadPoolExecutor(threads) as pool:
        for key, val in arrays.items():
            central.append(_write_member(fh, pool, threads, key + ".npy",
                                         val))
        start = fh.tell()
        for c in central:
            fh.write(c)
        end = fh.tell()
        count, size = len(central), end - start
        if count > _COUNT_LIMIT or start > _ZIP64_LIMIT \
                or size > _ZIP64_LIMIT:
            fh.write(_END64.pack(b"PK\x06\x06", _END64.size - 12, 45, 45, 0,
                                 0, count, count, size, start))
            fh.write(_END64_LOC.pack(b"PK\x06\x07", 0, end, 1))
            count, size = min(count, 0xFFFF), min(size, 0xFFFFFFFF)
            start = min(start, 0xFFFFFFFF)
        fh.write(_END.pack(b"PK\005\006", 0, 0, count, count, size, start, 0))
    return path


def chunk_table(info: zipfile.ZipInfo):
    """(chunk bytes, [deflated size of each chunk]) of a member written
    by write_npz, from its central directory extra field; None for any
    other member."""
    extra = info.extra
    while len(extra) >= 4:
        tp, ln = struct.unpack("<HH", extra[:4])
        if tp == CHUNK_TABLE_ID:
            body = extra[4:4 + ln]
            version, chunk = _TABLE_HEAD.unpack_from(body)
            if version != TABLE_VERSION:
                raise zipfile.BadZipFile(
                    f"member '{info.filename}': chunk table version "
                    f"{version}")
            n = (ln - _TABLE_HEAD.size) // 4
            return chunk, list(struct.unpack_from(f"<{n}I", body,
                                                  _TABLE_HEAD.size))
        extra = extra[4 + ln:]
    return None


def _inflate(fd: int, offset: int, csize: int, want: int, last: bool,
             name: str) -> bytes:
    """One chunk's bytes, checked to end where the table says."""
    d = zlib.decompressobj(-zlib.MAX_WBITS)
    try:
        raw = d.decompress(os.pread(fd, csize, offset), want + 1)
    except zlib.error as e:
        raise zipfile.BadZipFile(f"member '{name}': {e}") from None
    if len(raw) != want or d.eof != last or d.unused_data \
            or d.unconsumed_tail:
        raise zipfile.BadZipFile(f"member '{name}': a chunk does not "
                                 f"inflate to its {want} bytes")
    return raw


def _fill(fd, dst, lo: int, offset: int, csize: int, want: int, last: bool,
          name: str) -> int:
    raw = _inflate(fd, offset, csize, want, last, name)
    dst[lo:lo + want] = np.frombuffer(raw, np.uint8)
    return zlib.crc32(raw)


class NpzReader:
    """An npz file's arrays by name, as np.load(path) gives them: members
    with a chunk table inflated on `threads` threads (host_threads() by
    default), others through np.load.  Use as a context manager."""

    def __init__(self, path: str, threads: int | None = None):
        self.path = path
        self.threads = threads or host_threads()
        self._fd = os.open(path, os.O_RDONLY)
        try:
            self._zip = zipfile.ZipFile(path)
        except BaseException:
            os.close(self._fd)
            raise
        self._infos = {i.filename[:-4]: i for i in self._zip.infolist()
                       if i.filename.endswith(".npy")}
        self._np = None
        self._pool = None

    @property
    def files(self) -> list[str]:
        return list(self._infos)

    def __contains__(self, key: str) -> bool:
        return key in self._infos

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
        if self._np is not None:
            self._np.close()
            self._np = None
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1
        self._zip.close()

    def __getitem__(self, key: str) -> np.ndarray:
        info = self._infos[key]
        table = chunk_table(info)
        if table is None:
            if self._np is None:
                self._np = np.load(self.path, allow_pickle=False)
            return self._np[key]
        return self._read_chunked(info, *table)

    def _read_chunked(self, info, chunk: int, sizes: list[int]):
        name = info.filename
        if info.compress_type != zipfile.ZIP_DEFLATED \
                or sum(sizes) != info.compress_size or not sizes:
            raise zipfile.BadZipFile(f"member '{name}': its chunk table "
                                     f"does not match its entry")
        local = os.pread(self._fd, _LOCAL.size, info.header_offset)
        fields = _LOCAL.unpack(local)
        if fields[0] != b"PK\003\004":
            raise zipfile.BadZipFile(f"member '{name}': bad local header")
        start = info.header_offset + _LOCAL.size + fields[-2] + fields[-1]
        offsets = np.concatenate([[0], np.cumsum(sizes)]) + start
        # chunk 0: the .npy header
        d = zlib.decompressobj(-zlib.MAX_WBITS)
        try:
            head = d.decompress(os.pread(self._fd, sizes[0], start),
                                _MAX_HEADER)
        except zlib.error as e:
            raise zipfile.BadZipFile(f"member '{name}': {e}") from None
        fp = io.BytesIO(head)
        try:
            version = npy_format.read_magic(fp)
            if version == (1, 0):
                shape, fortran, dtype = npy_format.read_array_header_1_0(fp)
            elif version == (2, 0):
                shape, fortran, dtype = npy_format.read_array_header_2_0(fp)
            else:
                raise ValueError(f".npy version {version}")
        except (ValueError, SyntaxError, tokenize.TokenError) as e:
            raise zipfile.BadZipFile(f"member '{name}': bad .npy header "
                                     f"({e})") from None
        if dtype.hasobject:
            raise ValueError(f"member '{name}' holds objects")
        n = math.prod(shape) * dtype.itemsize
        n_chunks = -(-n // chunk)
        if fp.tell() != len(head) or d.unused_data or d.unconsumed_tail \
                or len(sizes) != 1 + n_chunks or d.eof != (n_chunks == 0) \
                or len(head) + n != info.file_size:
            raise zipfile.BadZipFile(f"member '{name}': its chunks do not "
                                     f"match its .npy header")
        out = np.empty(shape, dtype, order="F" if fortran else "C")
        dst = (out.T if fortran else out).reshape(-1).view(np.uint8)
        crc = zlib.crc32(head)
        if n_chunks:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(self.threads)
            jobs = []
            for k in range(n_chunks):
                lo = k * chunk
                want = min(chunk, n - lo)
                jobs.append((want, self._pool.submit(
                    _fill, self._fd, dst, lo, int(offsets[k + 1]),
                    sizes[k + 1], want, k == n_chunks - 1, name)))
            try:
                for want, job in jobs:
                    crc = _crc_join(crc, job.result(), want)
            except BaseException:
                for _, job in jobs:
                    job.cancel()
                raise
        if crc != info.CRC:
            raise zipfile.BadZipFile(f"member '{name}': CRC-32 mismatch")
        return out
