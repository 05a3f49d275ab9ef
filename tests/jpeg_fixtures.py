"""Seeded JPEG files and the two manifests of `tests/data/jpeg/`.

    python -m tests.jpeg_fixtures     # rewrites tests/data/jpeg/ (needs cv2 and PIL)

The folder holds JPEG files written by OpenCV and PIL: every sampling that
`cv2.imwrite` offers (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1), grey, a restart
interval, PIL's optimised Huffman tables, EXIF orientations 3, 6 and 8 in
both byte orders, odd sizes down to 1x1, qualities 5-100, progressive files
(OpenCV's, and PIL's with optimised tables), a CMYK file (PIL's), baseline
and progressive files cut short at two offsets each (one progressive cut in
its first scan, one in a refinement scan, so that libjpeg's block smoothing
runs), four photo-sized baseline files and one photo-sized progressive file
(`separate_scans` writes files of one scan per component, which neither
library does, for the tests), and files that no library here writes:
arithmetic-coded ones (SOF9 and SOF10 from `coefficients` by jcarith.c's
encoder, `arithmetic_jpeg`, whose output cv2 reads equal to the
`huffman_twin` of the same coefficients; non-default DAC conditioning, a
restart interval, two cut short, a photo-sized one) and lossless ones (SOF3,
`lossless_jpeg`: RGB at predictors 1 and 7, Pt 2 with a restart interval,
CMYK). `manifest.json` gives each file's shape and
the SHA-256 of what `cv2.imread(path, IMREAD_COLOR)` returns. `corruptions.json`
gives the SHA-256 of `htd_tpu.data.corruptions.corrupt` at severities 1-5
for each of the 19 corruptions, on `chip_smoke.probe_image`'s two seeded
images. `chip_smoke.py` (phase 26) and `tests/test_torch_jpeg.py` hold the
port to both on the machines they run on.
"""

from __future__ import annotations

import io
import json
import struct
from pathlib import Path

import numpy as np

from tests.jpeg_writers import (ADOBE_RGB, _dht, _flat_table, _segment, lossless_jpeg,  # noqa: F401
                                lossless_planes, photo)

ROOT = Path(__file__).resolve().parent / "data" / "jpeg"
CORRUPTION_SEED = 5       # the `seed` argument of `corrupt` in corruptions.json
# chip_smoke.probe_image's (seed, height, width): one with odd sides
PROBES = [(1, 96, 128), (2, 61, 83)]


def pattern(seed: int, h: int, w: int, noise: int = 30) -> np.ndarray:
    """Gradients with seeded noise, (h, w, 3) uint8 BGR."""
    r = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 3 + y) % 256, (y * 2 + 50) % 256, (x + y * 5) % 256], -1)
    return np.clip(base + r.randint(-noise, noise + 1, (h, w, 3)), 0, 255).astype(np.uint8)


def exif_app1(orientation: int, big_endian: bool) -> bytes:
    """An APP1 segment holding an EXIF TIFF block with one IFD0 entry,
    the orientation (tag 0x0112, SHORT)."""
    o = ">" if big_endian else "<"
    tiff = (b"MM" if big_endian else b"II") + struct.pack(o + "HI", 42, 8)
    tiff += struct.pack(o + "H", 1) + struct.pack(o + "HHIHH", 0x0112, 3, 1, orientation, 0)
    tiff += struct.pack(o + "I", 0)
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def with_exif(data: bytes, orientation: int, big_endian: bool = False) -> bytes:
    """`data` (a JPEG file) with an EXIF orientation segment after SOI."""
    return data[:2] + exif_app1(orientation, big_endian) + data[2:]


def cv2_jpeg(img: np.ndarray, quality: int = 95, sampling: int = 420, restart: int = 0,
             progressive: bool = False) -> bytes:
    import cv2

    ok, enc = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}"),
        cv2.IMWRITE_JPEG_RST_INTERVAL, restart, cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])
    assert ok
    return enc.tobytes()


def pil_jpeg(img: np.ndarray, **kwargs) -> bytes:
    """`img` (BGR, or grey 2-D) saved by PIL with `kwargs` (quality, subsampling, optimize)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img if img.ndim == 2 else img[..., ::-1]).save(buf, "JPEG", **kwargs)
    return buf.getvalue()


_ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
           41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
           30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]


def _category(v: int):
    """(size, the v's bits as JPEG codes them)."""
    s = abs(v).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _scan_symbols(blocks: np.ndarray, restart: int):
    """Per block, the (DC symbol, bits), then the AC (symbol, bits) of a
    sequential scan of (N, 64) natural-order coefficients."""
    out, pred = [], 0
    for i, blk in enumerate(blocks):
        if restart and i % restart == 0:
            pred = 0
        zz = [int(blk[k]) for k in _ZIGZAG]
        s, bits = _category(zz[0] - pred)
        pred = zz[0]
        syms, run = [(0, s, bits)], 0
        for v in zz[1:]:
            if v == 0:
                run += 1
                continue
            while run > 15:
                syms.append((1, 0xF0, None))
                run -= 16
            s, bits = _category(v)
            syms.append((1, run << 4 | s, (s, bits)))
            run = 0
        if run:
            syms.append((1, 0x00, None))
        out.append(syms)
    return out


def separate_scans(img: np.ndarray, quality: int = 75, subsampled: bool = True,
                   restart: int = 0, q16: bool = False, requant: bool = False) -> bytes:
    """A baseline JPEG of `img` (BGR) with one scan per component (no
    interleaving), written here: libjpeg-turbo's forward half from
    `htd_tpu_torch.data.jpeg`, flat Huffman tables per scan. `q16` writes
    16-bit quantisation tables; `requant` redefines table 1 between the Cb
    and the Cr scan (so Cr, whose first scan comes after it, latches the
    new one, and Cb keeps the old one)."""
    from htd_tpu_torch.data import jpeg as J

    h, w = img.shape[:2]
    luma_q, chroma_q = J.quant_tables(quality)
    y, cb, cr = J._rgb_to_ycc(img[..., ::-1])
    if subsampled:
        ch, cw = (h + 1) // 2, (w + 1) // 2
        pad = lambda p: np.pad(p, ((0, 2 * ch - h), (0, 2 * cw - w)), mode="edge")  # noqa: E731
        cb, cr = ((p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2] + 1) >> 2
                  for p in map(pad, (cb, cr)))
    second_q = np.clip(chroma_q * 3 // 2, 1, 255)

    def coefs(plane, table):
        ph, pw = plane.shape
        bh, bw = -(-ph // 8), -(-pw // 8)
        plane = np.pad(plane, ((0, bh * 8 - ph), (0, bw * 8 - pw)), mode="edge")
        return J._quantize(J._blocks(plane, bh, bw), table)

    comps = [(1, luma_q, coefs(y, luma_q)), (2, chroma_q, coefs(cb, chroma_q)),
             (3, second_q if requant else chroma_q, coefs(cr, second_q if requant else chroma_q))]

    def dqt(tq, table):
        if q16:
            return _segment(0xDB, bytes([0x10 | tq]) + b"".join(
                struct.pack(">H", int(table[k])) for k in _ZIGZAG))
        return _segment(0xDB, bytes([tq] + [int(table[k]) for k in _ZIGZAG]))

    hv = 0x22 if subsampled else 0x11
    out = b"\xff\xd8" + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += dqt(0, luma_q) + dqt(1, chroma_q)
    out += _segment(0xC0, struct.pack(">BHHB", 8, h, w, 3) + bytes(
        [1, hv, 0, 2, 0x11, 1, 3, 0x11, 1]))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    for cid, _, blocks in comps:
        if requant and cid == 3:
            out += dqt(1, second_q)
        syms = _scan_symbols(blocks, restart)
        dc = _flat_table(s[0][1] for s in syms)
        ac = _flat_table(x[1] for s in syms for x in s[1:]) or {0: (0, 1)}
        out += _dht(0, 0, dc) + _dht(1, 0, ac)
        out += _segment(0xDA, bytes([1, cid, 0x00, 0, 63, 0]))
        out += _huffman_data(syms, dc, ac, restart)
    return out + b"\xff\xd9"


class _BitWriter:
    """Huffman-coded bits, FF stuffed with 00, restart markers byte-aligned
    with one bits as libjpeg pads them."""

    def __init__(self):
        self.bits, self.nbits, self.data = 0, 0, bytearray()

    def put(self, code: int, n: int) -> None:
        self.bits, self.nbits = self.bits << n | code, self.nbits + n
        while self.nbits >= 8:
            byte = (self.bits >> (self.nbits - 8)) & 0xFF
            self.data.append(byte)
            if byte == 0xFF:
                self.data.append(0)
            self.nbits -= 8

    def align(self) -> None:
        if self.nbits:
            self.put((1 << (8 - self.nbits)) - 1, 8 - self.nbits)

    def restart(self, n: int) -> None:
        self.align()
        self.data.extend([0xFF, 0xD0 + n % 8])


def _huffman_data(syms, dc: dict, ac: dict, restart: int) -> bytes:
    """A sequential scan's entropy-coded data from `_scan_symbols`' symbols."""
    w = _BitWriter()
    for i, blk in enumerate(syms):
        if restart and i and i % restart == 0:
            w.restart(i // restart - 1)
        for k, (is_ac, sym, extra) in enumerate(blk):
            w.put(*(ac if is_ac else dc)[sym])
            size, value = (sym, extra) if k == 0 else (extra or (0, 0))
            if size:
                w.put(value, size)
    w.align()
    return bytes(w.data)


# ---------------------------------------------------------------- arithmetic-coded files

# luma's sampling factors (h, v) per sampling; chroma is 1x1
LUMA_HV = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2)}


def coefficients(img: np.ndarray, quality: int = 75, sampling: str = "420") -> dict:
    """libjpeg-turbo's forward half of `img` (BGR, or grey if 2-D) at
    `quality` (`htd_tpu_torch.data.jpeg`'s colour conversion, islow DCT and
    quantisation; chroma downsampled by a plain box average): the frame's
    size, its components (id, h, v, table), both quantisation tables and
    each component's quantised blocks (rows, cols, 64) in natural order over
    whole MCUs (the plane edge-replicated), which every file written from
    them shares."""
    from htd_tpu_torch.data import jpeg as J

    h, w = img.shape[:2]
    tables = J.quant_tables(quality)
    if img.ndim == 2:
        planes, comps = [img.astype(np.int64)], [(1, 1, 1, 0)]
    else:
        hx, vx = LUMA_HV[sampling]
        y, cb, cr = J._rgb_to_ycc(img[..., ::-1])

        def down(p):
            ch, cw = -(-h // vx), -(-w // hx)
            p = np.pad(p, ((0, ch * vx - h), (0, cw * hx - w)), mode="edge")
            return (sum(p[i::vx, j::hx] for i in range(vx) for j in range(hx)) + hx * vx // 2) \
                // (hx * vx)

        planes, comps = [y, down(cb), down(cr)], [(1, hx, vx, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    blocks = []
    for (_, ch, cv, tq), p in zip(comps, planes):
        rows, cols = mcuy * cv, mcux * ch
        p = np.pad(p, ((0, rows * 8 - p.shape[0]), (0, cols * 8 - p.shape[1])), mode="edge")
        blocks.append(J._quantize(J._blocks(p, rows, cols), tables[tq]).reshape(rows, cols, 64))
    return dict(height=h, width=w, comps=comps, tables=tables, blocks=blocks)


def _real_blocks(frame: dict, i: int) -> np.ndarray:
    """Component i's blocks that hold image samples, (bh * bw, 64)."""
    _, ch, cv, _ = frame["comps"][i]
    hmax = max(c[1] for c in frame["comps"])
    vmax = max(c[2] for c in frame["comps"])
    bh = -(-(-(-frame["height"] * cv // vmax)) // 8)
    bw = -(-(-(-frame["width"] * ch // hmax)) // 8)
    return frame["blocks"][i][:bh, :bw].reshape(-1, 64)


def _frame_segments(frame: dict, sof: int) -> bytes:
    """SOI, JFIF, the quantisation tables and the frame header."""
    comps = frame["comps"]
    out = b"\xff\xd8" + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for tq in sorted({c[3] for c in comps}):
        out += _segment(0xDB, bytes([tq] + [int(frame["tables"][tq][k]) for k in _ZIGZAG]))
    return out + _segment(sof, struct.pack(">BHHB", 8, frame["height"], frame["width"],
                                           len(comps))
                          + b"".join(bytes([cid, ch << 4 | cv, tq]) for cid, ch, cv, tq in comps))


def huffman_twin(frame: dict) -> bytes:
    """A baseline Huffman file of `frame`'s coefficients, one scan per
    component (flat tables), the twin that an arithmetic file of the same
    coefficients must decode equal to."""
    out = _frame_segments(frame, 0xC0)
    for i, (cid, *_rest) in enumerate(frame["comps"]):
        syms = _scan_symbols(_real_blocks(frame, i), 0)
        dc = _flat_table(s[0][1] for s in syms)
        ac = _flat_table(x[1] for s in syms for x in s[1:]) or {0: (0, 1)}
        out += _dht(0, 0, dc) + _dht(1, 0, ac) + _segment(0xDA, bytes([1, cid, 0x00, 0, 63, 0]))
        out += _huffman_data(syms, dc, ac, 0)
    return out + b"\xff\xd9"


# ITU-T T.81 Table D.2 as libjpeg's jaricom.c lists it: (Qe, Next_Index_LPS,
# Next_Index_MPS, Switch_MPS); entry 113 is the fixed 0.5 estimate (T.851)
# for signs and DC refinement bits.
_QE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]


class ArithEncoder:
    """jcarith.c's arithmetic encoder (T.81 Annex D): `encode(stats, i,
    bit)` codes one decision with the adaptive estimate in stats[i] (one
    byte: MPS << 7 | state), `finish` terminates the segment (D.1.8)."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self) -> None:
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _zeros(self) -> None:
        self.out += bytes(self.zc)
        self.zc = 0

    def _byte(self, b: int) -> None:
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _stacked(self) -> None:
        """The byte in `buffer` and the stacked FF bytes, none overflowing."""
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self.out.append(self.buffer)
        if self.sc:
            self._zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def _carry(self) -> None:
        if self.buffer >= 0:
            self._zeros()
            self._byte(self.buffer + 1)
        self.zc += self.sc
        self.sc = 0

    def encode(self, stats: bytearray, i: int, val: int) -> None:
        sv = stats[i]
        qe, nl, nm, switch = _QE[sv & 0x7F]
        nl |= switch << 7
        self.a -= qe
        if val != sv >> 7:                      # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nm
        while True:                             # renormalisation, D.1.6
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._stacked()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                return

    def finish(self) -> None:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._stacked()
        if self.c & 0x7FFF800:
            self._zeros()
            self._byte((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._byte((self.c >> 11) & 0xFF)


def _shift(v: int, al: int) -> int:
    """An AC coefficient's point transform: |v| >> al with v's sign."""
    return (abs(v) >> al) * (1 if v >= 0 else -1)


class _ArithScan:
    """jcarith.c's MCU encoders for one scan: sequential, and the four
    progressive kinds (DC first / refine, AC first / refine)."""

    def __init__(self, enc: ArithEncoder, ncomp: int, dac: dict, ss, se, ah, al, progressive):
        self.enc, self.ss, self.se, self.ah, self.al = enc, ss, se, ah, al
        self.progressive, self.dac = progressive, dac
        self.fixed = bytearray([113])
        self.dc_stats = [bytearray(64) for _ in range(ncomp)]
        self.ac_stats = [bytearray(256) for _ in range(ncomp)]
        self.last_dc, self.context = [0] * ncomp, [0] * ncomp

    def reset(self) -> None:
        for st in self.dc_stats + self.ac_stats:
            st[:] = bytes(len(st))
        self.last_dc = [0] * len(self.last_dc)
        self.context = [0] * len(self.context)

    def _magnitude(self, st: bytearray, pos: int, x_bins: int, v: int) -> None:
        """Figures F.8 and F.9: the category of v - 1 >= 0 from bin `pos`
        (X bins from `x_bins` on), then its bits."""
        enc = self.enc
        m = 0
        v -= 1
        if v:
            enc.encode(st, pos, 1)
            m = 1
            v2 = v >> 1
            if x_bins < 0:                     # DC: X1 = 20, next bins after it
                pos = 20
                while v2:
                    enc.encode(st, pos, 1)
                    m <<= 1
                    pos += 1
                    v2 >>= 1
            elif v2:
                enc.encode(st, pos, 1)
                m <<= 1
                pos = x_bins
                v2 >>= 1
                while v2:
                    enc.encode(st, pos, 1)
                    m <<= 1
                    pos += 1
                    v2 >>= 1
        enc.encode(st, pos, 0)
        pos += 14
        mm = m
        while mm >> 1:
            mm >>= 1
            enc.encode(st, pos, 1 if mm & v else 0)
        return m

    def dc(self, ci: int, tbl: int, value: int) -> None:
        st, enc = self.dc_stats[tbl], self.enc
        s0 = self.context[ci]
        v = value - self.last_dc[ci]
        if v == 0:
            enc.encode(st, s0, 0)
            self.context[ci] = 0
            return
        self.last_dc[ci] = value
        enc.encode(st, s0, 1)
        if v > 0:
            enc.encode(st, s0 + 1, 0)
            pos, self.context[ci] = s0 + 2, 4
        else:
            v = -v
            enc.encode(st, s0 + 1, 1)
            pos, self.context[ci] = s0 + 3, 8
        m = self._magnitude(st, pos, -1, v)
        low, up = self.dac.get(("dc", tbl), (0, 1))
        if m < (1 << low) >> 1:
            self.context[ci] = 0
        elif m > (1 << up) >> 1:
            self.context[ci] += 8

    def ac(self, tbl: int, blk, ss: int, se: int, al: int) -> None:
        """Figure F.5 (G.1.3.2 with the point transform): coefficients ss-se."""
        st, enc = self.ac_stats[tbl], self.enc
        kx = self.dac.get(("ac", tbl), 5)
        vals = [_shift(int(blk[_ZIGZAG[k]]), al) for k in range(64)]
        ke = se
        while ke > 0 and vals[ke] == 0:
            ke -= 1
        k = ss
        while k <= ke:
            pos = 3 * (k - 1)
            enc.encode(st, pos, 0)
            while vals[k] == 0:
                enc.encode(st, pos + 1, 0)
                pos += 3
                k += 1
            enc.encode(st, pos + 1, 1)
            v = vals[k]
            enc.encode(self.fixed, 0, 0 if v > 0 else 1)
            self._magnitude(st, pos + 2, 189 if k <= kx else 217, abs(v))
            k += 1
        if k <= se:
            enc.encode(st, 3 * (k - 1), 1)

    def ac_refine(self, tbl: int, blk) -> None:
        """Figure G.10: one more bit (Al) of coefficients ss-se."""
        st, enc = self.ac_stats[tbl], self.enc
        absv = [abs(int(blk[_ZIGZAG[k]])) for k in range(64)]
        ke = self.se
        while ke > 0 and absv[ke] >> self.al == 0:
            ke -= 1
        kex = ke
        while kex > 0 and absv[kex] >> self.ah == 0:
            kex -= 1
        k = self.ss
        while k <= ke:
            pos = 3 * (k - 1)
            if k > kex:
                enc.encode(st, pos, 0)
            while True:
                v = absv[k] >> self.al
                if v:
                    if v >> 1:
                        enc.encode(st, pos + 2, v & 1)
                    else:
                        enc.encode(st, pos + 1, 1)
                        enc.encode(self.fixed, 0, 0 if blk[_ZIGZAG[k]] > 0 else 1)
                    break
                enc.encode(st, pos + 1, 0)
                pos += 3
                k += 1
            k += 1
        if k <= self.se:
            enc.encode(st, 3 * (k - 1), 1)

    def block(self, pos: int, ci: int, blk) -> None:
        """Block `blk` of frame component `ci`, the scan's component `pos`."""
        tbl = 1 if ci else 0
        if not self.progressive:
            self.dc(pos, tbl, int(blk[0]))
            self.ac(tbl, blk, 1, 63, 0)
        elif self.ss == 0 and self.ah == 0:
            self.dc(pos, tbl, int(blk[0]) >> self.al)
        elif self.ss == 0:
            self.enc.encode(self.fixed, 0, (int(blk[0]) >> self.al) & 1)
        elif self.ah == 0:
            self.ac(tbl, blk, self.ss, self.se, self.al)
        else:
            self.ac_refine(tbl, blk)


# jcparam.c's jpeg_simple_progression: (components, Ss, Se, Ah, Al)
PROGRESSION_YCC = [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                   ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                   ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                   ((0,), 1, 63, 1, 0)]
PROGRESSION_GREY = [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
                    ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]


def arithmetic_jpeg(frame: dict, progressive: bool = False, restart: int = 0,
                    dac: dict | None = None) -> bytes:
    """An arithmetic-coded file (SOF9 sequential, one interleaved scan, or
    SOF10 progressive with libjpeg's standard scan script) of `frame`'s
    coefficients, written with jcarith.c's encoder. `restart` is a restart
    interval in MCUs; `dac` maps ("dc", table) to conditioning (L, U) and
    ("ac", table) to Kx, written in a DAC segment (libjpeg's defaults are
    (0, 1) and 5). Tables: 0 for the first component, 1 for the others."""
    dac = dac or {}
    comps = frame["comps"]
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    out = _frame_segments(frame, 0xCA if progressive else 0xC9)
    if dac:
        out += _segment(0xCC, b"".join(
            bytes([(key[0] == "ac") << 4 | key[1], val if key[0] == "ac" else val[1] << 4 | val[0]])
            for key, val in sorted(dac.items())))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    script = ([(tuple(range(len(comps))), 0, 63, 0, 0)] if not progressive else
              PROGRESSION_GREY if len(comps) == 1 else PROGRESSION_YCC)
    for members, ss, se, ah, al in script:
        out += _segment(0xDA, bytes([len(members)]) + b"".join(
            bytes([comps[i][0], (i and 1) << 4 | (i and 1)]) for i in members)
            + bytes([ss, se, ah << 4 | al]))
        enc = ArithEncoder()
        scan = _ArithScan(enc, len(comps), dac, ss, se, ah, al, progressive)
        if len(members) > 1:
            rows, cols = frame["blocks"][0].shape[0] // comps[0][2], \
                frame["blocks"][0].shape[1] // comps[0][1]
            mcus = [[(ci, frame["blocks"][ci][my * comps[ci][2] + v, mx * comps[ci][1] + h])
                     for ci in members for v in range(comps[ci][2]) for h in range(comps[ci][1])]
                    for my in range(rows) for mx in range(cols)]
        else:
            ci = members[0]
            mcus = [[(ci, b)] for b in _real_blocks(frame, ci)]
        for n, mcu in enumerate(mcus):
            if restart and n and n % restart == 0:
                enc.finish()
                enc.out += bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
                enc.reset()
                scan.reset()
            for ci, blk in mcu:
                scan.block(members.index(ci), ci, blk)
        enc.finish()
        out += bytes(enc.out)
    return out + b"\xff\xd9"


def cmyk_jpeg(img: np.ndarray, quality: int = 85, **kwargs) -> bytes:
    """`img` (BGR) converted to CMYK and saved by PIL (Adobe marker, transform 0)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img[..., ::-1]).convert("CMYK").save(buf, "JPEG", quality=quality, **kwargs)
    return buf.getvalue()


def scans(data: bytes) -> list:
    """(start, end) of each scan's entropy-coded data: from just past its SOS
    segment to the next marker other than RSTn."""
    out, pos = [], 0
    while (pos := data.find(b"\xff\xda", pos)) >= 0:
        start = end = pos + 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        while not (data[end] == 0xFF and data[end + 1] not in (0, 0xFF, *range(0xD0, 0xD8))):
            end += 1
        out.append((start, end))
        pos = end
    return out


def fixture_files() -> dict:
    """name -> bytes of every fixture."""
    import cv2

    files = {}
    for samp, (h, w), q in [(444, (37, 50), 90), (422, (41, 29), 60), (420, (33, 47), 75),
                            (440, (26, 35), 50), (411, (19, 67), 85)]:
        files[f"cv2_{samp}_{h}x{w}_q{q}.jpg"] = cv2_jpeg(pattern(samp, h, w), q, samp)
    for (h, w), q in [((1, 1), 5), ((2, 3), 100), ((7, 5), 25), ((9, 17), 12)]:
        files[f"cv2_420_{h}x{w}_q{q}.jpg"] = cv2_jpeg(pattern(h * w, h, w), q)
    grey = cv2.cvtColor(pattern(3, 23, 31), cv2.COLOR_BGR2GRAY)
    ok, enc = cv2.imencode(".jpg", grey, [cv2.IMWRITE_JPEG_QUALITY, 70])
    files["cv2_grey_23x31.jpg"] = enc.tobytes()
    files["cv2_restart3_40x56.jpg"] = cv2_jpeg(pattern(4, 40, 56), 80, 420, restart=3)
    files["pil_optimize_45x38_q80.jpg"] = pil_jpeg(pattern(5, 45, 38), quality=80, optimize=True)
    files["pil_444_30x21_q20.jpg"] = pil_jpeg(pattern(6, 30, 21), quality=20, subsampling=0)
    files["pil_422_21x30_q95.jpg"] = pil_jpeg(pattern(7, 21, 30), quality=95, subsampling=1)
    files["pil_grey_17x13_q40.jpg"] = pil_jpeg(pattern(8, 17, 13)[..., 0], quality=40)
    for o, big in [(3, False), (6, True), (8, False)]:
        files[f"exif{o}_{'mm' if big else 'ii'}_20x36.jpg"] = with_exif(
            cv2_jpeg(pattern(10 + o, 20, 36), 85), o, big)
    files["progressive_32x48.jpg"] = cv2_jpeg(pattern(9, 32, 48), 80, progressive=True)
    files["pil_progressive_optimize_45x38_q80.jpg"] = pil_jpeg(
        pattern(14, 45, 38), quality=80, progressive=True, optimize=True)
    files["pil_cmyk_27x41_q85.jpg"] = cmyk_jpeg(pattern(15, 27, 41), 85)
    base = cv2_jpeg(pattern(16, 40, 56), 90, 420, restart=4)
    (start, end), = scans(base)
    for tag, cut in (("a", start + (end - start) // 3), ("b", end - 100)):
        files[f"cut_baseline_40x56_{tag}.jpg"] = base[:cut]
    prog = cv2_jpeg(pattern(17, 40, 56), 85, progressive=True)
    first, refine = scans(prog)[0], scans(prog)[-2]
    for tag, cut in (("a", (first[0] + first[1]) // 2), ("b", (refine[0] + refine[1]) // 2)):
        files[f"cut_progressive_40x56_{tag}.jpg"] = prog[:cut]
    for i in range(4):
        hw = (427, 640) if i % 2 == 0 else (640, 427)
        img = photo(i, *hw)
        files[f"photo{i}.jpg"] = (
            cv2_jpeg(img, 80) if i == 0 else pil_jpeg(img, quality=75) if i == 1 else
            cv2_jpeg(img, 90, 422, restart=8) if i == 2 else pil_jpeg(img, quality=85,
                                                                      optimize=True))
    files["photo4_progressive.jpg"] = cv2_jpeg(photo(4, 427, 640), 80, progressive=True)
    files.update(arithmetic_files())
    files.update(lossless_files())
    return files


DAC = {("dc", 0): (2, 5), ("dc", 1): (1, 3), ("ac", 0): 2, ("ac", 1): 30}


def arithmetic_files() -> dict:
    """name -> bytes of the arithmetic-coded fixtures (SOF9 and SOF10,
    written from the coefficients of a Huffman twin): 4:2:0, 4:4:4 with
    non-default DAC conditioning, 4:2:2 with a restart interval, a
    sequential and a progressive file cut short, and a photo-sized one."""
    files = {}
    f420 = coefficients(pattern(40, 40, 56), 80, "420")
    files["arith_420_40x56_q80.jpg"] = arithmetic_jpeg(f420)
    files["arith_progressive_420_40x56_q80.jpg"] = arithmetic_jpeg(f420, progressive=True)
    files["arith_dac_444_33x47_q75.jpg"] = arithmetic_jpeg(
        coefficients(pattern(41, 33, 47), 75, "444"), dac=DAC)
    files["arith_restart3_422_41x29_q90.jpg"] = arithmetic_jpeg(
        coefficients(pattern(42, 41, 29), 90, "422"), restart=3)
    seq = arithmetic_jpeg(coefficients(pattern(44, 40, 56), 85, "420"), restart=5)
    prog = arithmetic_jpeg(coefficients(pattern(45, 40, 56), 85, "420"), progressive=True)
    (start, end), = scans(seq)
    files["cut_arith_40x56_a.jpg"] = seq[:(start + end) // 2]
    refine = scans(prog)[-3]
    files["cut_arith_progressive_40x56_b.jpg"] = prog[:(refine[0] + refine[1]) // 2]
    files["photo5_arith.jpg"] = arithmetic_jpeg(coefficients(photo(5, 427, 640), 80, "420"))
    return files


def lossless_files() -> dict:
    """name -> bytes of the lossless fixtures (SOF3), all of which imread
    reads: RGB (Adobe transform 0) at predictors 1 and 7, the latter with
    Pt 2 and a restart interval, and CMYK."""
    img = pattern(50, 24, 32)
    rgb = lossless_planes(img, "rgb")
    k = pattern(51, 24, 32)[..., 1]
    return {
        "lossless_rgb_p1_24x32.jpg": lossless_jpeg(rgb, 1, app=ADOBE_RGB),
        "lossless_rgb_p7_pt2_restart_24x32.jpg": lossless_jpeg(rgb, 7, 2, 3, app=ADOBE_RGB),
        "lossless_cmyk_p5_24x32.jpg": lossless_jpeg(rgb + [k], 5, app=ADOBE_RGB),
    }


def corruption_hashes() -> dict:
    """corruption -> severity -> [sha256 of the JAX package's output per probe image]."""
    from chip_smoke import probe_image, sha256
    from htd_tpu.data.corruptions import ALL_CORRUPTIONS, corrupt

    images = [probe_image(*p) for p in PROBES]
    return {name: {str(sev): [sha256(corrupt(img, name, sev, seed=CORRUPTION_SEED))
                              for img in images] for sev in range(1, 6)}
            for name in ALL_CORRUPTIONS}


def main() -> None:
    import cv2

    from chip_smoke import sha256

    ROOT.mkdir(parents=True, exist_ok=True)
    for old in ROOT.glob("*.jpg"):
        old.unlink()
    manifest = {}
    for name, data in fixture_files().items():
        (ROOT / name).write_bytes(data)
        img = cv2.imread(str(ROOT / name), cv2.IMREAD_COLOR)
        manifest[name] = {"shape": list(img.shape), "sha256": sha256(img)}
    (ROOT / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    (ROOT / "corruptions.json").write_text(json.dumps(
        {"seed": CORRUPTION_SEED, "probes": PROBES, "sha256": corruption_hashes()},
        indent=1) + "\n")


if __name__ == "__main__":
    main()
