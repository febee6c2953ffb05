"""PNG files on the standard library alone (zlib, struct): the eval and
train CLIs write their images with it where Pillow is not installed.

`write_png` writes an 8-bit RGB (H, W, 3) or greyscale (H, W) / (H, W, 1)
uint8 array as one IDAT chunk, every row with filter 0. `decode_png` reads
such bytes back (every chunk's CRC checked), and `read_png` such a file,
where Pillow is absent.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
COLOR_TYPES = {1: 0, 3: 2}  # channels → PNG colour type (greyscale, truecolour)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray, level: int = 6) -> bytes:
    """The PNG bytes of a uint8 (H, W), (H, W, 1) or (H, W, 3) array."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8 arrays, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[2] not in COLOR_TYPES:
        raise ValueError(f"PNG writer takes (H, W), (H, W, 1) or (H, W, 3), got {arr.shape}")
    h, w, c = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(arr).reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, COLOR_TYPES[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def write_png(path: str, arr: np.ndarray) -> str:
    with open(path, "wb") as f:
        f.write(encode_png(arr))
    return path


def read_png(path: str) -> np.ndarray:
    """The PNG file at `path`, as `decode_png` reads it."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_png(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes of `encode_png`'s kind (8-bit RGB or greyscale, not
    interlaced, row filter 0) as uint8 (H, W, 3) or (H, W); ValueError for
    anything else."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError("truncated PNG")
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if pos + 12 + n > len(data):
            raise ValueError("truncated PNG")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if crc != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError(f"bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError("no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    channels = {v: k for k, v in COLOR_TYPES.items()}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"only 8-bit RGB or greyscale, not interlaced "
                         f"(depth {depth}, colour type {color}, interlace {interlace})")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, w * channels + 1)
    except zlib.error as e:
        raise ValueError(f"bad image data: {e}") from None
    if raw[:, 0].any():
        raise ValueError(f"row filters {sorted(set(raw[:, 0].tolist()))}; this reader "
                         "takes filter 0 only, as encode_png writes")
    img = raw[:, 1:].reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img
