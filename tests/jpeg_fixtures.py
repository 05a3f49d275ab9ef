"""Seeded JPEG files and the two manifests of `tests/data/jpeg/`.

    python -m tests.jpeg_fixtures     # rewrites tests/data/jpeg/ (needs cv2 and PIL)

The folder holds JPEG files written by OpenCV and PIL: every sampling that
`cv2.imwrite` offers (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1), grey, a restart
interval, PIL's optimised Huffman tables, EXIF orientations 3, 6 and 8 in
both byte orders, odd sizes down to 1x1, qualities 5-100, one progressive
file and four photo-sized ones (`separate_scans` writes files of one
scan per component, which neither library does, for the tests).
`manifest.json` gives each file's shape and
the SHA-256 of what `cv2.imread(path, IMREAD_COLOR)` returns (the
progressive file: that the port must refuse it). `corruptions.json` gives
the SHA-256 of `htd_tpu.data.corruptions.corrupt` at severities 1-5 for
each corruption the port has, on `chip_smoke.probe_image`'s two seeded
images. `chip_smoke.py` (phase 26) and `tests/test_torch_jpeg.py` hold the
port to both on the machines they run on.
"""

from __future__ import annotations

import io
import json
import struct
from pathlib import Path

import numpy as np

from chip_smoke import probe_image, sha256

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


def _segment(code: int, body: bytes) -> bytes:
    return bytes([0xFF, code]) + struct.pack(">H", len(body) + 2) + body


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
        bits, nbits, data = 0, 0, bytearray()

        def put(code, n):
            nonlocal bits, nbits
            bits, nbits = bits << n | code, nbits + n
            while nbits >= 8:
                byte = (bits >> (nbits - 8)) & 0xFF
                data.append(byte)
                if byte == 0xFF:
                    data.append(0)
                nbits -= 8

        for i, blk in enumerate(syms):
            if restart and i and i % restart == 0:
                if nbits:
                    put((1 << (8 - nbits)) - 1, 8 - nbits)
                data.extend([0xFF, 0xD0 + (i // restart - 1) % 8])
            for k, (is_ac, sym, extra) in enumerate(blk):
                table = ac if is_ac else dc
                put(*table[sym])
                size, value = (sym, extra) if k == 0 else (extra or (0, 0))
                if size:
                    put(value, size)
        if nbits:
            put((1 << (8 - nbits)) - 1, 8 - nbits)
        out += bytes(data)
    return out + b"\xff\xd9"


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
    for i in range(4):
        hw = (427, 640) if i % 2 == 0 else (640, 427)
        img = photo(i, *hw)
        files[f"photo{i}.jpg"] = (
            cv2_jpeg(img, 80) if i == 0 else pil_jpeg(img, quality=75) if i == 1 else
            cv2_jpeg(img, 90, 422, restart=8) if i == 2 else pil_jpeg(img, quality=85,
                                                                      optimize=True))
    return files


def corruption_hashes() -> dict:
    """corruption -> severity -> [sha256 of the JAX package's output per probe image]."""
    from htd_tpu.data.corruptions import corrupt
    from htd_tpu_torch.data.corruptions import PORTED_CORRUPTIONS

    images = [probe_image(*p) for p in PROBES]
    return {name: {str(sev): [sha256(corrupt(img, name, sev, seed=CORRUPTION_SEED))
                              for img in images] for sev in range(1, 6)}
            for name in PORTED_CORRUPTIONS}


def main() -> None:
    import cv2

    ROOT.mkdir(parents=True, exist_ok=True)
    for old in ROOT.glob("*.jpg"):
        old.unlink()
    manifest = {}
    for name, data in fixture_files().items():
        (ROOT / name).write_bytes(data)
        if name.startswith("progressive"):
            manifest[name] = {"raises": "ValueError"}
            continue
        img = cv2.imread(str(ROOT / name), cv2.IMREAD_COLOR)
        manifest[name] = {"shape": list(img.shape), "sha256": sha256(img)}
    (ROOT / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    (ROOT / "corruptions.json").write_text(json.dumps(
        {"seed": CORRUPTION_SEED, "probes": PROBES, "sha256": corruption_hashes()},
        indent=1) + "\n")


if __name__ == "__main__":
    main()
