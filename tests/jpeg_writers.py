"""JPEG writers that need no image library and nothing of the JAX package:
a photo-like seeded picture, a lossless (SOF3) Huffman file writer, and
libjpeg-turbo's forward half in numpy (colour conversion, islow DCT,
quantisation), the reference the port's C++ forward half is held to.
`tests/jpeg_fixtures.py` writes its lossless and coefficient-level fixtures
with them, and `chip_smoke.py` its photo-sized lossless file."""

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


def fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def rgb_to_ycc(rgb: np.ndarray):
    """jccolor.c's rgb_ycc_convert (SCALEBITS 16, Cb and Cr rounded with
    0.5 - epsilon)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + offset + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + offset + half - 1) >> 16
    return y, cb, cr


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """jfdctint.c's jpeg_fdct_islow on (N, 8, 8) level-shifted samples
    (int64); the result is 8x the DCT, as libjpeg leaves it."""
    c_bits, p_bits = 13, 2

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    def one_pass(d, first):
        # d: (..., 8) along the transformed axis, last
        t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
        t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
        t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
        t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
        t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
        out = np.empty_like(d)
        sh = c_bits - p_bits if first else c_bits + p_bits
        if first:
            out[..., 0] = (t10 + t11) << p_bits
            out[..., 4] = (t10 - t11) << p_bits
        else:
            out[..., 0] = descale(t10 + t11, p_bits)
            out[..., 4] = descale(t10 - t11, p_bits)
        z1 = (t12 + t13) * 4433
        out[..., 2] = descale(z1 + t13 * 6270, sh)
        out[..., 6] = descale(z1 - t12 * 15137, sh)
        z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
        z5 = (z3 + z4) * 9633
        t4, t5, t6, t7 = t4 * 2446, t5 * 16819, t6 * 25172, t7 * 12299
        z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
        out[..., 7] = descale(t4 + z1 + z3, sh)
        out[..., 5] = descale(t5 + z2 + z4, sh)
        out[..., 3] = descale(t6 + z2 + z3, sh)
        out[..., 1] = descale(t7 + z1 + z4, sh)
        return out

    rows = one_pass(blocks, True)
    return one_pass(rows.transpose(0, 2, 1), False).transpose(0, 2, 1)


def to_blocks(plane: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """The (bh * 8, bw * 8) top-left of an edge-padded plane as (bh * bw, 8, 8)."""
    return plane[:bh * 8, :bw * 8].reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)


def quantize(blocks: np.ndarray, table: np.ndarray) -> np.ndarray:
    """jcdctmgr.c: each coefficient over 8 x its step, rounded half away from 0."""
    coef = fdct_islow(blocks - 128).reshape(-1, 64)
    d = table * 8
    q = (np.abs(coef) + d // 2) // d
    return (np.sign(coef) * q).astype(np.int16)


def forward_reference(img: np.ndarray, quality: int):
    """The reference `htd_tpu_torch.data.jpeg._forward` is held to: libjpeg-turbo's lossy half of a (H, W, 3) uint8 BGR image at `quality`
    (4:2:0): each component's quantised blocks, (rows, cols, 64) int16 in
    natural order, over its plane edge-replicated to whole blocks, and the
    luminance and chrominance tables."""
    from htd_tpu_torch.data.jpeg import quant_tables

    h, w = img.shape[:2]
    luma_q, chroma_q = quant_tables(quality)
    ybh, ybw = -(-h // 8), -(-w // 8)
    y, cb, cr = rgb_to_ycc(img[..., ::-1])
    ch, cbh, cbw = (h + 1) // 2, -(-((h + 1) // 2) // 8), -(-((w + 1) // 2) // 8)
    # Edge replication as jcprepct.c and jcsample.c do it: luma to whole
    # blocks; chroma's input to whole blocks across and to an even row
    # count, then its downsampled rows to whole blocks.
    y = np.pad(y, ((0, ybh * 8 - h), (0, ybw * 8 - w)), mode="edge")
    coefs = [quantize(to_blocks(y, ybh, ybw), luma_q).reshape(ybh, ybw, 64)]
    bias = np.tile([1, 2], cbw * 4)   # per output column: 1, 2, 1, 2, ...
    for p in (cb, cr):
        p = np.pad(p, ((0, 2 * ch - h), (0, cbw * 16 - w)), mode="edge")
        down = (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2] + bias) >> 2
        down = np.pad(down, ((0, cbh * 8 - ch), (0, 0)), mode="edge")
        coefs.append(quantize(to_blocks(down, cbh, cbw), chroma_q).reshape(cbh, cbw, 64))
    return coefs, luma_q, chroma_q


def lossless_planes(img: np.ndarray, color: str) -> list:
    """The sample planes a lossless file of `img` (BGR) holds: "grey" its
    first channel, "rgb" R, G, B, "ycc" jccolor.c's Y, Cb, Cr."""
    if color == "grey":
        return [img[..., 0] if img.ndim == 3 else img]
    if color == "rgb":
        return [img[..., 2], img[..., 1], img[..., 0]]
    return list(rgb_to_ycc(img[..., ::-1]))


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
