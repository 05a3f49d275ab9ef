"""JPEG writers that need no image library and nothing of the JAX package:
a photo-like seeded picture and a lossless (SOF3) Huffman file writer.
`tests/jpeg_fixtures.py` writes its lossless fixtures with them, and
`chip_smoke.py` its photo-sized lossless file."""

from __future__ import annotations

import struct

import numpy as np


def photo(seed: int, h: int, w: int) -> np.ndarray:
    """A photo-sized seeded picture: gradients, a dozen flat ellipses and
    mild noise (so that it compresses like a photograph)."""
    r = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.int64)
    img = np.zeros((h, w, 3), np.int64)
    for c in range(3):
        a, b = r.randint(-3, 4, 2)
        img[..., c] = (x * a + y * b) // 4 + r.randint(40, 200)
    for _ in range(12):
        cy, cx, ry, rx = r.randint(0, h), r.randint(0, w), r.randint(10, h // 3), r.randint(10, w // 3)
        img[((y - cy) ** 2 * rx * rx + (x - cx) ** 2 * ry * ry) <= (rx * ry) ** 2] = \
            r.randint(0, 256, 3)
    img += r.randint(-6, 7, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _segment(code: int, body: bytes) -> bytes:
    return bytes([0xFF, code]) + struct.pack(">H", len(body) + 2) + body


def _flat_table(symbols) -> dict:
    """A valid (if not optimal) Huffman table: every used symbol one code of
    the same length, none all ones."""
    used = sorted(set(symbols))
    length = len(used).bit_length()
    return {sym: (i, length) for i, sym in enumerate(used)}


def _dht(tc: int, th: int, table: dict) -> bytes:
    counts = [0] * 16
    counts[next(iter(table.values()))[1] - 1] = len(table)
    return _segment(0xC4, bytes([tc << 4 | th] + counts) + bytes(sorted(table,
                                                                     key=lambda s: table[s][0])))


ADOBE_RGB = _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")   # transform 0: RGB


def lossless_planes(img: np.ndarray, color: str) -> list:
    """The sample planes a lossless file of `img` (BGR) holds: "grey" its
    first channel, "rgb" R, G, B, "ycc" jccolor.c's Y, Cb, Cr."""
    if color == "grey":
        return [img[..., 0] if img.ndim == 3 else img]
    if color == "rgb":
        return [img[..., 2], img[..., 1], img[..., 0]]
    from htd_tpu_torch.data import jpeg as J

    return list(J._rgb_to_ycc(img[..., ::-1]))


def _pack_bits(values: np.ndarray, nbits: np.ndarray) -> bytes:
    """Codes of nbits[i] bits each (MSB first), packed, padded with one
    bits to a whole byte and FF-stuffed with 00."""
    width = int(nbits.max(initial=1))
    j = np.arange(width)
    bits = (values[:, None] >> (width - 1 - j)) & 1
    bits = bits[j >= width - nbits[:, None]]
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, bits.dtype)]).astype(np.uint8)
    data = np.packbits(bits)
    return bytes(np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0))


def lossless_jpeg(planes: list, predictor: int = 1, pt: int = 0, restart_rows: int = 0,
                  precision: int = 8, app: bytes = b"", ids=None, hv=None) -> bytes:
    """A lossless Huffman file (SOF3, T.81 Annex H) of the sample planes
    (each a component at its sampling's size, values below 2**precision),
    one interleaved scan: predictor 1-7, point transform `pt`, a restart
    interval of `restart_rows` MCU rows, the segments `app` after SOI
    (ADOBE_RGB, or a JFIF segment), component ids (1, 2, 3, ... by default)
    and sampling factors `hv` ((1, 1) each by default). The first row of the
    scan and of each restart interval predicts its first sample by
    2**(precision - pt - 1) and the rest by the left neighbour; each later
    row predicts its first sample by the one above (jcpred.c)."""
    n = len(planes)
    ids = ids or list(range(1, n + 1))
    hv = hv or [(1, 1)] * n
    hmax, vmax = max(h for h, _ in hv), max(v for _, v in hv)
    height = max(p.shape[0] * vmax // v for p, (_, v) in zip(planes, hv))
    width = max(p.shape[1] * hmax // h for p, (h, _) in zip(planes, hv))
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    per_row = width if n == 1 else mcux
    columns = []
    for p, (h, v) in zip(planes, hv):
        x = p.astype(np.int64) >> pt
        rows, cols = x.shape
        d = np.zeros((mcuy * v, mcux * h) if n > 1 else (rows, cols), np.int64)
        for r in range(rows):             # dummy samples keep difference 0
            if r == 0 or (restart_rows and r % (restart_rows * (v if n > 1 else 1)) == 0):
                pred = np.concatenate([[1 << (precision - pt - 1)], x[r, :-1]])
            else:
                ra = np.concatenate([[0], x[r, :-1]])
                rb, rc = x[r - 1], np.concatenate([[0], x[r - 1, :-1]])
                pred = [ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1),
                        (ra + rb) >> 1][predictor - 1].copy()
                pred[0] = rb[0]
            dd = (x[r] - pred) & 0xFFFF
            d[r, :cols] = np.where(dd > 32768, dd - 65536, dd)
        if n > 1:   # MCU order: each MCU's v x h samples of this component
            d = d.reshape(mcuy, v, mcux, h).transpose(0, 2, 1, 3).reshape(mcuy * mcux, v * h)
        columns.append(d.reshape(-1, 1) if n == 1 else d)
    diffs = np.concatenate(columns, axis=1)            # (MCUs, samples per MCU)
    mag = np.abs(diffs)
    size = np.where(mag == 0, 0, np.floor(np.log2(np.maximum(mag, 1))).astype(np.int64) + 1)
    extra = np.where(diffs >= 0, diffs, diffs + (1 << size) - 1)
    table = _flat_table(np.unique(size).tolist())
    length = next(iter(table.values()))[1]
    code = np.zeros(17, np.int64)
    for sym, (c, _) in table.items():
        code[sym] = c
    nbits = length + np.where(size == 16, 0, size)
    values = code[size] << np.where(size == 16, 0, size) | np.where(size == 16, 0, extra)
    out = b"\xff\xd8" + app + _segment(0xC3, struct.pack(">BHHB", precision, height, width, n)
                                       + b"".join(bytes([i, h << 4 | v, 0])
                                                  for i, (h, v) in zip(ids, hv)))
    out += _dht(0, 0, table)
    interval = restart_rows * per_row
    if interval:
        out += _segment(0xDD, struct.pack(">H", interval))
    out += _segment(0xDA, bytes([n]) + b"".join(bytes([i, 0]) for i in ids)
                    + bytes([predictor, 0, pt]))
    step = interval or len(diffs)
    for k, m in enumerate(range(0, len(diffs), step)):
        if k:
            out += bytes([0xFF, 0xD0 + (k - 1) % 8])
        out += _pack_bits(values[m:m + step].reshape(-1), nbits[m:m + step].reshape(-1))
    return out + b"\xff\xd9"
