"""LMDB access in Python: a read-only B+tree reader and a minimal writer
(port of `udifftext_tpu/data/lmdb.py`; the files either package writes read
back byte for byte in the other).

The reference's STR benchmark sets are LMDB databases read through the
`lmdb` C library (src/parseq/strhub/data/dataset.py:31-137). This module
implements the on-disk format directly:

- `LMDBReader`: mmap the data file, pick the live meta page, walk the main
  DB's B+tree for point `get(key)` and in-order `items()` iteration.
  Supports the subset the parseq datasets need (no DUPSORT, no nested DBs).
- `open_lmdb`: the native reader (`lmdb_native`) where it builds, else
  `LMDBReader`.
- `write_lmdb`: a minimal single-transaction writer (sorted keys, leaf +
  branch pages, overflow pages for big values, both meta pages), whose
  files the `lmdb` package reads.
- `LmdbStrDataset`: the parseq layout with strhub's label preprocessing;
  `decode_image` turns its image bytes into an RGB array.

Format reference: LMDB's public `lmdb.h`/`mdb.c` layout for the 64-bit
little-endian build (the layout the published datasets use):
  meta:   magic 0xBEEFC0DE, version 1, psize in mm_dbs[0].md_pad
  page:   16-byte header (pgno u64, pad u16, flags u16, lower u16, upper u16)
  node:   8-byte header (lo u16, hi u16, flags u16, ksize u16) + key + data
  branch node pgno = lo | hi<<16 | flags<<32 ; leaf datasize = lo | hi<<16
  F_BIGDATA (0x01): value is an 8-byte overflow page number
"""

from __future__ import annotations

import io
import mmap
import os
import struct
import unicodedata
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..utils.png import decode_png

MAGIC = 0xBEEFC0DE
VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

F_BIGDATA = 0x01

PAGEHDRSZ = 16
NODEHDRSZ = 8
INVALID_PGNO = 0xFFFFFFFFFFFFFFFF

# MDB_db: md_pad u32, md_flags u16, md_depth u16, branch/leaf/overflow pgno
# u64×3, md_entries u64, md_root u64  → 48 bytes
_DB = struct.Struct("<IHHQQQQQ")
# meta after page header: magic u32, version u32, address u64, mapsize u64
_META_HEAD = struct.Struct("<IIQQ")
_PGHDR = struct.Struct("<QHHHH")
_NODEHDR = struct.Struct("<HHHH")


def _data_path(path: str) -> str:
    return os.path.join(path, "data.mdb") if os.path.isdir(path) else path


class LMDBReader:
    """Read-only main-DB access to an LMDB file."""

    def __init__(self, path: str):
        self.path = _data_path(path)
        self._f = open(self.path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        meta = self._pick_meta()
        self.psize: int = meta["psize"]
        self.entries: int = meta["main"][6]
        self._root: int = meta["main"][7]

    # -- meta ---------------------------------------------------------------

    def _read_meta(self, off: int) -> Optional[Dict]:
        """Parse a meta page at byte offset `off`; None if invalid."""
        if off + PAGEHDRSZ + _META_HEAD.size + 2 * _DB.size + 16 > len(self._mm):
            return None
        hdr = _PGHDR.unpack_from(self._mm, off)
        if not hdr[2] & P_META:
            return None
        magic, version, _addr, _mapsize = _META_HEAD.unpack_from(self._mm, off + PAGEHDRSZ)
        if magic != MAGIC or version != VERSION:
            return None
        dbs_off = off + PAGEHDRSZ + _META_HEAD.size
        free_db = _DB.unpack_from(self._mm, dbs_off)
        main_db = _DB.unpack_from(self._mm, dbs_off + _DB.size)
        last_pg, txnid = struct.unpack_from("<QQ", self._mm, dbs_off + 2 * _DB.size)
        return {
            "psize": free_db[0] or 4096,  # mm_psize lives in mm_dbs[0].md_pad
            "free": free_db,
            "main": main_db,
            "last_pg": last_pg,
            "txnid": txnid,
        }

    def _pick_meta(self) -> Dict:
        # Meta 0 is at offset 0; meta 1 at offset psize, which meta 0's
        # mm_dbs[0].md_pad records. If meta 0 is unreadable, probe the
        # common OS page sizes for meta 1.
        m0 = self._read_meta(0)
        psizes = [m0["psize"]] if m0 else [4096, 8192, 16384, 32768, 65536]
        metas = [m0] if m0 else []
        for ps in dict.fromkeys(psizes):
            m1 = self._read_meta(ps)
            if m1:
                metas.append(m1)
                break
        if not metas:
            raise ValueError(f"{self.path}: not an LMDB data file")
        if m0 and len(metas) == 1 and m0["last_pg"] > 1:
            # a live DB always has both metas; meta 1 not parsing at the
            # psize meta 0 declares means a layout we'd silently misread
            raise ValueError(
                f"{self.path}: meta page 1 invalid at offset {m0['psize']}"
            )
        return max(metas, key=lambda m: m["txnid"])

    # -- pages --------------------------------------------------------------

    def _page(self, pgno: int) -> Tuple[int, int, int, int]:
        """(offset, flags, lower, upper) of a page."""
        off = pgno * self.psize
        _pg, _pad, flags, lower, upper = _PGHDR.unpack_from(self._mm, off)
        return off, flags, lower, upper

    def _numkeys(self, lower: int) -> int:
        return (lower - PAGEHDRSZ) >> 1

    def _node(self, page_off: int, idx: int) -> Tuple[int, int, int, bytes]:
        """(lo|hi composite, flags, ksize, key) of node idx; returns the node
        offset context via closure-free tuple — see _leaf_value/_branch_pgno."""
        ptr = struct.unpack_from("<H", self._mm, page_off + PAGEHDRSZ + 2 * idx)[0]
        noff = page_off + ptr
        lo, hi, flags, ksize = _NODEHDR.unpack_from(self._mm, noff)
        key = bytes(self._mm[noff + NODEHDRSZ : noff + NODEHDRSZ + ksize])
        return noff, (lo | (hi << 16) | (flags << 32)), flags, key

    def _leaf_value(self, noff: int, flags: int, ksize: int) -> bytes:
        lo, hi = struct.unpack_from("<HH", self._mm, noff)
        dsize = lo | (hi << 16)
        data_off = noff + NODEHDRSZ + ksize
        if flags & F_BIGDATA:
            (ov_pgno,) = struct.unpack_from("<Q", self._mm, data_off)
            ov_off = ov_pgno * self.psize
            return bytes(self._mm[ov_off + PAGEHDRSZ : ov_off + PAGEHDRSZ + dsize])
        return bytes(self._mm[data_off : data_off + dsize])

    # -- B+tree -------------------------------------------------------------

    def get(self, key: bytes) -> Optional[bytes]:
        if self._root == INVALID_PGNO:
            return None
        pgno = self._root
        while True:
            off, flags, lower, upper = self._page(pgno)
            n = self._numkeys(lower)
            if flags & P_BRANCH:
                # descend into the last child whose key <= target; node 0's
                # key is the implicit -inf
                child = None
                for i in range(n):
                    noff, composite, nflags, nkey = self._node(off, i)
                    if i == 0 or nkey <= key:
                        child = composite & 0xFFFFFFFFFFFF
                    else:
                        break
                pgno = child
            elif flags & P_LEAF:
                for i in range(n):
                    noff, _comp, nflags, nkey = self._node(off, i)
                    if nkey == key:
                        return self._leaf_value(noff, nflags, len(nkey))
                    if nkey > key:
                        return None
                return None
            else:
                raise ValueError(f"unexpected page flags {flags:#x}")

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """In-order iteration over the main DB."""
        if self._root == INVALID_PGNO:
            return
        stack: List[Tuple[int, int]] = [(self._root, 0)]
        while stack:
            pgno, idx = stack.pop()
            off, flags, lower, upper = self._page(pgno)
            n = self._numkeys(lower)
            if flags & P_LEAF:
                for i in range(n):
                    noff, _c, nflags, nkey = self._node(off, i)
                    yield nkey, self._leaf_value(noff, nflags, len(nkey))
            elif flags & P_BRANCH:
                if idx < n:
                    stack.append((pgno, idx + 1))
                    _noff, composite, _f, _k = self._node(off, idx)
                    stack.append((composite & 0xFFFFFFFFFFFF, 0))

    def __len__(self) -> int:
        return self.entries

    def close(self):
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_lmdb(path: str):
    """Open an LMDB for reading: the native C++ reader
    (`native/lmdb_reader.cpp`, built with g++ at first use) when it builds,
    else the Python `LMDBReader`; both have get / items / __len__ / close.
    UDIFFTEXT_LMDB=py|native forces a backend ("native" raises when the
    build fails)."""
    forced = os.environ.get("UDIFFTEXT_LMDB", "").lower()
    if forced == "py":
        return LMDBReader(path)
    from . import lmdb_native

    if forced == "native" or lmdb_native.available():
        return lmdb_native.NativeLMDBReader(path)  # raises if unavailable
    return LMDBReader(path)


# ---------------------------------------------------------------------------
# Minimal writer (fixtures / preprocessing output)
# ---------------------------------------------------------------------------


def _pack_page(pgno: int, flags: int, nodes: List[bytes], psize: int) -> bytes:
    """Assemble a branch/leaf page: ptrs grow up from the header, node bodies
    grow down from the page end."""
    lower = PAGEHDRSZ + 2 * len(nodes)
    upper = psize
    body = bytearray(psize)
    ptrs = []
    for node in reversed(nodes):
        upper -= len(node)
        body[upper : upper + len(node)] = node
        ptrs.append(upper)
    ptrs.reverse()
    _PGHDR.pack_into(body, 0, pgno, 0, flags, lower, upper)
    for i, p in enumerate(ptrs):
        struct.pack_into("<H", body, PAGEHDRSZ + 2 * i, p)
    return bytes(body)


def _leaf_node(key: bytes, data: bytes, big_pgno: Optional[int]) -> bytes:
    dsize = len(data)
    flags = F_BIGDATA if big_pgno is not None else 0
    hdr = _NODEHDR.pack(dsize & 0xFFFF, dsize >> 16, flags, len(key))
    payload = struct.pack("<Q", big_pgno) if big_pgno is not None else data
    node = hdr + key + payload
    return node + b"\x00" * (len(node) & 1)  # 2-byte align


def _branch_node(key: bytes, child: int) -> bytes:
    hdr = _NODEHDR.pack(child & 0xFFFF, (child >> 16) & 0xFFFF,
                        (child >> 32) & 0xFFFF, len(key))
    node = hdr + key
    return node + b"\x00" * (len(node) & 1)


def write_lmdb(path: str, items: Dict[bytes, bytes], psize: int = 4096,
               map_size: int = 0):
    """Write {key: value} as a valid single-version LMDB database at `path`
    (a directory, like lmdb.open default: creates data.mdb + lock.mdb)."""
    os.makedirs(path, exist_ok=True)
    entries = sorted(items.items())
    pages: Dict[int, bytes] = {}
    next_pg = 2  # 0/1 are meta

    def alloc(n=1):
        nonlocal next_pg
        p = next_pg
        next_pg += n
        return p

    cap = psize - PAGEHDRSZ
    # 1 ptr + header + key + data must fit; lmdb's actual threshold is
    # psize/16 for values, but any split point that fits is valid
    max_inline = cap // 2

    n_overflow = 0

    def leaf_entry(key: bytes, val: bytes) -> bytes:
        nonlocal n_overflow
        if NODEHDRSZ + len(key) + len(val) > max_inline:
            n_pages = -(-(PAGEHDRSZ + len(val)) // psize)
            ov = alloc(n_pages)
            buf = bytearray(n_pages * psize)
            _PGHDR.pack_into(buf, 0, ov, 0, P_OVERFLOW, 0, 0)
            struct.pack_into("<I", buf, 12, n_pages)  # mp_pb.pb_pages
            buf[PAGEHDRSZ : PAGEHDRSZ + len(val)] = val
            for i in range(n_pages):
                pages[ov + i] = bytes(buf[i * psize : (i + 1) * psize])
            n_overflow += n_pages
            return _leaf_node(key, val, ov)
        return _leaf_node(key, val, None)

    # pack leaves
    leaf_pages: List[Tuple[bytes, int]] = []  # (first_key, pgno)
    cur_nodes: List[bytes] = []
    cur_size = 0
    cur_first: Optional[bytes] = None
    n_leaf = 0

    def flush_leaf():
        nonlocal cur_nodes, cur_size, cur_first, n_leaf
        if not cur_nodes:
            return
        pg = alloc()
        pages[pg] = _pack_page(pg, P_LEAF, cur_nodes, psize)
        leaf_pages.append((cur_first, pg))
        n_leaf += 1
        cur_nodes, cur_size, cur_first = [], 0, None

    for key, val in entries:
        node = leaf_entry(key, val)
        if cur_nodes and cur_size + len(node) + 2 > cap:
            flush_leaf()
        if not cur_nodes:
            cur_first = key
        cur_nodes.append(node)
        cur_size += len(node) + 2
    flush_leaf()

    # build branch levels
    level = leaf_pages
    depth = 1
    n_branch = 0
    while len(level) > 1:
        next_level: List[Tuple[bytes, int]] = []
        i = 0
        while i < len(level):
            nodes: List[bytes] = []
            size = 0
            first_key = level[i][0]
            j = i
            while j < len(level):
                key = b"" if j == i else level[j][0]
                node = _branch_node(key, level[j][1])
                if nodes and size + len(node) + 2 > cap:
                    break
                nodes.append(node)
                size += len(node) + 2
                j += 1
            pg = alloc()
            pages[pg] = _pack_page(pg, P_BRANCH, nodes, psize)
            n_branch += 1
            next_level.append((first_key, pg))
            i = j
        level = next_level
        depth += 1

    root = level[0][1] if level else INVALID_PGNO
    if not entries:
        depth = 0

    last_pg = next_pg - 1
    map_size = max(map_size, next_pg * psize)

    def meta_page(pgno: int, txnid: int) -> bytes:
        buf = bytearray(psize)
        _PGHDR.pack_into(buf, 0, pgno, 0, P_META, 0, 0)
        _META_HEAD.pack_into(buf, PAGEHDRSZ, MAGIC, VERSION, 0, map_size)
        dbs_off = PAGEHDRSZ + _META_HEAD.size
        # FREE_DBI: empty; md_pad carries psize
        _DB.pack_into(buf, dbs_off, psize, 0, 0, 0, 0, 0, 0, INVALID_PGNO)
        # MAIN_DBI
        _DB.pack_into(buf, dbs_off + _DB.size, 0, 0, depth, n_branch, n_leaf,
                      n_overflow, len(entries), root)
        struct.pack_into("<QQ", buf, dbs_off + 2 * _DB.size, last_pg, txnid)
        return bytes(buf)

    data = _data_path(path) if os.path.isdir(path) else path
    with open(data, "wb") as f:
        f.write(meta_page(0, 0))
        f.write(meta_page(1, 1))
        for pg in range(2, next_pg):
            f.write(pages.get(pg, b"\x00" * psize))
    lock = os.path.join(os.path.dirname(data), "lock.mdb")
    if not os.path.exists(lock):
        open(lock, "wb").close()


# ---------------------------------------------------------------------------
# parseq-layout STR dataset (strhub/data/dataset.py:31-137)
# ---------------------------------------------------------------------------


def decode_image(data: bytes) -> np.ndarray:
    """Encoded image bytes → uint8 (H, W, 3) RGB: through Pillow where it is
    installed (any format it reads, `.convert("RGB")`); without Pillow only
    PNGs of `utils.png.encode_png`'s kind, and anything else raises."""
    try:
        from PIL import Image
    except ImportError:
        try:
            img = decode_png(data)
        except ValueError as e:
            raise RuntimeError(f"cannot decode this image without Pillow ({e}); install "
                               "Pillow to read JPEG or other PNG files") from e
        return np.repeat(img[..., None], 3, axis=2) if img.ndim == 2 else img
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


MAX_LABEL_LEN = 25  # strhub's max_label_length


def prep_label(label: str, adapter=None) -> Optional[str]:
    """strhub/data/dataset.py:84-106's label preprocessing: whitespace
    removed, NFKD folded to ASCII, the length filter BEFORE the charset
    adapter (`str_eval.CharsetAdapter`: case folding for single-case
    charsets, unsupported characters stripped, not dropped), then None for
    a label that is empty, as for one that is too long: the reference's
    datamodule leaves both samples out."""
    label = "".join(label.split())
    label = unicodedata.normalize("NFKD", label).encode("ascii", "ignore").decode()
    if len(label) > MAX_LABEL_LEN:
        return None
    if adapter is not None:
        label = adapter(label)
    return label or None


class LmdbStrDataset:
    """The parseq LMDB layout: b'num-samples', b'image-%09d' (encoded image
    bytes), b'label-%09d' (utf-8 text); indices are 1-based. Items are
    (uint8 (H, W, 3) RGB array, label), labels through `prep_label`."""

    def __init__(self, path: str, charset: Optional[str] = None):
        from ..str_eval import CharsetAdapter

        adapter = CharsetAdapter(charset) if charset is not None else None
        self.db = open_lmdb(path)
        n = int(self.db.get(b"num-samples") or b"0")
        self.filtered: List[int] = []
        self.labels: List[str] = []
        for i in range(1, n + 1):
            raw = self.db.get(b"label-%09d" % i)
            if raw is None:
                continue
            label = prep_label(raw.decode("utf-8", "ignore"), adapter)
            if label is None:
                continue
            self.filtered.append(i)
            self.labels.append(label)

    def __len__(self) -> int:
        return len(self.filtered)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, str]:
        return decode_image(self.db.get(b"image-%09d" % self.filtered[idx])), self.labels[idx]

    def close(self):
        self.db.close()
