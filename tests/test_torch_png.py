"""The port's PNG reader (`htd_tpu_torch.data.png.read_png`) against
OpenCV's `imread(IMREAD_COLOR)`, bit for bit, on seeded PNG files of every
colour type and row filter, and `CocoDataset.load_image` without OpenCV."""

import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from htd_tpu_torch.data import coco as pcoco
from htd_tpu_torch.data.png import SIGNATURE, read_png, write_png as port_write_png

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filter_rows(px: np.ndarray, types) -> bytes:
    """PNG-filter (H, W, C) uint8 samples, row r with filter types[r]."""
    x = px.astype(np.int16)
    left = np.zeros_like(x)
    left[:, 1:] = x[:, :-1]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, 1:] = x[:-1, :-1]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = (np.zeros_like(x), left, up, (left + up) >> 1, paeth)
    rows = [bytes([t]) + ((x[r] - preds[t][r]) & 255).astype(np.uint8).tobytes()
            for r, t in enumerate(types)]
    return b"".join(rows)


def write_png(path, px, ctype, types, palette=None, depth=8, interlace=0, extra=()):
    """A PNG file of `px` (H, W, C) in colour type `ctype`, row r filtered
    with types[r]; `extra` chunks go before the image data."""
    h, w = px.shape[:2]
    out = SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    for kind, body in extra:
        out += _chunk(kind, body)
    out += _chunk(b"IDAT", zlib.compress(_filter_rows(px, types), 6))
    out += _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)


def _samples(rng, h, w, ch):
    """Smooth seeded samples (so that the predictors matter) with noise."""
    base = rng.randint(0, 256, (1, 1, ch)) + np.arange(h)[:, None, None] * 3 + \
        np.arange(w)[None, :, None] * 5
    return ((base + rng.randint(0, 40, (h, w, ch))) % 256).astype(np.uint8)


FILTERS = ["none", "sub", "up", "average", "paeth", "mixed"]


@pytest.mark.parametrize("ctype", sorted(CHANNELS))
@pytest.mark.parametrize("filt", FILTERS)
def test_read_png_matches_cv2(tmp_path, ctype, filt):
    """Each colour type (grey, RGB, palette, grey + alpha, RGBA) with each
    row filter, and all five filters mixed row by row: bit-equal to cv2."""
    rng = np.random.RandomState(10 * ctype + FILTERS.index(filt))
    h, w = 13, 17
    palette = None
    if ctype == 3:
        palette = rng.randint(0, 256, (200, 3))
        px = rng.randint(0, 200, (h, w, 1)).astype(np.uint8)
    else:
        px = _samples(rng, h, w, CHANNELS[ctype])
    types = [FILTERS.index(filt)] * h if filt != "mixed" else [r % 5 for r in range(h)]
    path = str(tmp_path / "img.png")
    write_png(path, px, ctype, types, palette=palette)
    got = read_png(path)
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    assert got.shape == want.shape == (h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_read_png_ancillary_chunks_and_transparency(tmp_path):
    """A palette image with a tRNS chunk (transparency, dropped), a text
    chunk and the image data split over three IDAT chunks; an RGB image
    with a tRNS colour key: as cv2 reads them."""
    rng = np.random.RandomState(3)
    h, w = 9, 11
    palette = rng.randint(0, 256, (16, 3))
    px = rng.randint(0, 16, (h, w, 1)).astype(np.uint8)
    path = str(tmp_path / "pal.png")
    write_png(path, px, 3, [r % 5 for r in range(h)], palette=palette,
              extra=[(b"tRNS", bytes(range(0, 256, 16))), (b"tEXt", b"Comment\x00seeded")])
    data = open(path, "rb").read()
    i = data.index(b"IDAT") - 4
    n = struct.unpack(">I", data[i:i + 4])[0]
    body = data[i + 8:i + 8 + n]
    parts = [body[:5], body[5:9], body[9:]]
    with open(path, "wb") as f:
        f.write(data[:i] + b"".join(_chunk(b"IDAT", p) for p in parts) + data[i + 12 + n:])
    np.testing.assert_array_equal(read_png(path), cv2.imread(path, cv2.IMREAD_COLOR))
    rgb = _samples(rng, h, w, 3)
    write_png(path, rgb, 2, [4] * h, extra=[(b"tRNS", struct.pack(">HHH", *rgb[0, 0]))])
    np.testing.assert_array_equal(read_png(path), cv2.imread(path, cv2.IMREAD_COLOR))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_read_png_of_cv2_files(tmp_path, rng, channels):
    """Files that cv2 (libpng) writes, with its adaptive choice of filters,
    at 60x90: grey, BGR and BGRA."""
    img = _samples(rng, 60, 90, channels)
    path = str(tmp_path / "cv.png")
    cv2.imwrite(path, img if channels > 1 else img[..., 0])
    np.testing.assert_array_equal(read_png(path), cv2.imread(path, cv2.IMREAD_COLOR))


@pytest.mark.parametrize("case", ["interlaced", "16-bit", "grey 4-bit", "not a PNG",
                                  "bad filter", "bad CRC", "truncated"])
def test_read_png_raises(tmp_path, rng, case):
    """Interlaced, 16-bit and sub-byte files, other formats and damaged
    files raise ValueError."""
    path = str(tmp_path / "bad.png")
    px = _samples(rng, 6, 7, 3)
    if case == "interlaced":
        write_png(path, px, 2, [0] * 6, interlace=1)
    elif case == "16-bit":
        write_png(path, px, 2, [0] * 6, depth=16)
    elif case == "grey 4-bit":
        write_png(path, px[..., :1], 0, [0] * 6, depth=4)
    elif case == "not a PNG":
        cv2.imwrite(str(tmp_path / "bad.jpg"), px)
        path = str(tmp_path / "bad.jpg")
    else:
        write_png(path, px, 2, [0] * 6)
        data = bytearray(open(path, "rb").read())
        if case == "bad filter":
            raw = bytearray(zlib.decompress(data[data.index(b"IDAT") + 4:-16]))
            raw[0] = 5
            body = zlib.compress(bytes(raw))
            i = data.index(b"IDAT") - 4
            data = data[:i] + _chunk(b"IDAT", body) + _chunk(b"IEND", b"")
        elif case == "bad CRC":
            data[data.index(b"IDAT") + 6] ^= 1
        else:
            data = data[:-30]
        open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError):
        read_png(path)


def test_load_image_without_cv2(tmp_path, rng, monkeypatch):
    """`CocoDataset.load_image` reads a PNG and a JPEG as cv2 reads them,
    each through the port's own decoder, whether or not cv2 can be
    imported, and raises ValueError naming the file on another format
    (BMP) either way: no file goes through cv2."""
    img = _samples(rng, 30, 40, 3)
    cv2.imwrite(str(tmp_path / "a.png"), img)
    cv2.imwrite(str(tmp_path / "b.jpg"), img)
    cv2.imwrite(str(tmp_path / "c.bmp"), img)
    want = [cv2.imread(str(tmp_path / n), cv2.IMREAD_COLOR) for n in ("a.png", "b.jpg")]
    ann = tmp_path / "ann.json"
    ann.write_text('{"images": [{"id": 1, "file_name": "a.png", "height": 30, "width": 40}, '
                   '{"id": 2, "file_name": "b.jpg", "height": 30, "width": 40}, '
                   '{"id": 3, "file_name": "c.bmp", "height": 30, "width": 40}], '
                   '"annotations": [], "categories": [{"id": 1, "name": "a"}]}')
    ds = pcoco.CocoDataset(str(ann), str(tmp_path), test_mode=True)
    for without_cv2 in (False, True):
        if without_cv2:
            monkeypatch.setitem(sys.modules, "cv2", None)
        for rec, ref in zip(ds.records, want):
            np.testing.assert_array_equal(ds.load_image(rec), ref)
        with pytest.raises(ValueError, match=r"c\.bmp.*neither a PNG nor a JPEG"):
            ds.load_image(ds.records[2])


@pytest.mark.parametrize("channels", [1, 3])
def test_write_png(channels, tmp_path):
    """`write_png` (grey and BGR, odd sizes down to 1x1, row r filtered with
    type r % 5): read_png and cv2.imread give the image back, grey as three
    equal channels; anything but (H, W) or (H, W, 3) uint8 raises."""
    rng = np.random.RandomState(channels)
    for h, w in [(1, 1), (2, 7), (17, 33), (64, 48)]:
        img = rng.randint(0, 256, (h, w, 3)[:2 if channels == 1 else 3]).astype(np.uint8)
        path = tmp_path / f"w{h}x{w}.png"
        port_write_png(path, img)
        want = img if channels == 3 else np.repeat(img[..., None], 3, axis=2)
        np.testing.assert_array_equal(read_png(path), want)
        np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_COLOR), want)
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 4), np.uint8)):
        with pytest.raises(ValueError, match="uint8"):
            port_write_png(tmp_path / "bad.png", bad)
