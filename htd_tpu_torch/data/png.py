"""PNG decoding and encoding with the standard library's zlib and numpy.

`read_png` returns what OpenCV's `cv2.imread(path, cv2.IMREAD_COLOR)`
returns for the 8-bit, non-interlaced PNG files it reads: (H, W, 3) uint8
in BGR order, grey replicated into the three channels, a palette looked
up, an alpha channel (and any tRNS transparency) dropped. The port reads
images with its own decoders, PNG here and JPEG in `data/jpeg.py`
(`CocoDataset.load_image` picks one by the file's signature), never with
OpenCV; any other PNG raises `ValueError`. `write_png` writes an 8-bit grey
or BGR image as a PNG file, which the tools use in place of `cv2.imwrite`.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel: grey, RGB, palette, grey + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes, path):
    """(type, body) of each chunk up to IEND; a critical chunk's CRC is
    checked (libpng only warns on an ancillary one)."""
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise ValueError(f"{path}: truncated PNG file")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        body = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if not kind[0] & 0x20 and zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: CRC error in the {kind!r} chunk")
        pos = end + 4
        yield kind, body
        if kind == b"IEND":
            return


def _unfilter(filt: np.ndarray, types: np.ndarray) -> np.ndarray:
    """Undo the row filters (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) of
    (H, W, C) filtered samples. Pixel (r, c) is predicted from (r, c - 1),
    (r - 1, c) and (r - 1, c - 1), so the pixels of one anti-diagonal
    r + c = k do not depend on each other: a skewed copy stores pixel
    (r, c) at [r + c + 2, r + 1] (zero entries above and to the left), so
    that each anti-diagonal is one contiguous slice, reconstructed at once
    from the two slices before it."""
    h, w, ch = filt.shape
    fs = np.zeros((h + w + 1, h, ch), np.int16)
    for r in range(h):
        fs[r + 2:r + 2 + w, r] = filt[r]
    s = np.zeros((h + w + 1, h + 1, ch), np.int16)
    zero = np.zeros((1, ch), np.int16)
    for k in range(h + w - 1):
        r0, r1 = max(0, k - w + 1), min(h - 1, k) + 1
        a = s[k + 1, r0 + 1:r1 + 1]     # left
        b = s[k + 1, r0:r1]             # up
        c = s[k, r0:r1]                 # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(types[r0:r1, None], (zero, a, b, (a + b) >> 1, paeth))
        s[k + 2, r0 + 1:r1 + 1] = (fs[k + 2, r0:r1] + pred) & 255
    out = np.empty((h, w, ch), np.uint8)
    for r in range(h):
        out[r] = s[r + 2:r + 2 + w, r + 1]
    return out


def read_png(path) -> np.ndarray:
    """The PNG file at `path` as (H, W, 3) uint8 BGR, as OpenCV's
    `imread(path, IMREAD_COLOR)` gives it. Reads bit depth 8 in every
    colour type (grey, RGB, palette, grey + alpha, RGBA) with any of the
    five row filters; raises `ValueError` on other bit depths, interlaced
    files and malformed data."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if len(body) % 3 or len(body) > 768:
                raise ValueError(f"{path}: invalid palette of {len(body)} bytes")
            palette = np.zeros((256, 3), np.uint8)   # indices past the palette read as black
            palette[:len(body) // 3] = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, compression, filter_method, interlace = header
    if depth != 8:
        raise ValueError(f"{path}: bit depth {depth}; only 8-bit PNG files are read")
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: invalid colour type {ctype}")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG files are not read")
    if compression or filter_method:
        raise ValueError(f"{path}: unknown compression or filter method")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    ch = _CHANNELS[ctype]
    size = h * (1 + w * ch)
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from e
    if len(raw) < size:
        raise ValueError(f"{path}: {len(raw)} bytes of image data, {size} expected")
    rows = np.frombuffer(raw, np.uint8, count=size).reshape(h, 1 + w * ch)
    types = rows[:, 0]
    if types.max(initial=0) > 4:
        raise ValueError(f"{path}: invalid row filter {types.max()}")
    px = _unfilter(rows[:, 1:].reshape(h, w, ch), types)
    if ctype == 3:
        return np.ascontiguousarray(palette[px[..., 0]][..., ::-1])
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., 2::-1])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path, img: np.ndarray) -> None:
    """Write (H, W) grey or (H, W, 3) BGR uint8 `img` to `path` as an 8-bit
    grey or RGB PNG file, zlib at level 1: row r filtered with type r % 5
    (None, Sub, Up, Average, Paeth), so that reading it back goes through
    every filter, as it does for the files libpng writes. `read_png` and
    `cv2.imread` read it back as `img` (grey as three equal channels)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8, not {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    x = img.reshape(h, w, -1)[..., ::-1].astype(np.int16)
    left, up, upleft = (np.zeros_like(x) for _ in range(3))
    left[:, 1:], up[1:], upleft[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    types = np.arange(h) % 5
    pred = np.choose(types[:, None, None], (np.zeros_like(x), left, up, (left + up) >> 1, paeth))
    rows = np.concatenate([types[:, None], ((x - pred) & 255).reshape(h, -1)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if img.ndim == 2 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.astype(np.uint8).tobytes(), 1))
                + _chunk(b"IEND", b""))
