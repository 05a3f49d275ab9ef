"""JPEG decoding on the host, and PIL's JPEG round trip.

`read_jpeg` returns what OpenCV's `cv2.imread(path, cv2.IMREAD_COLOR)`
returns for a JPEG file: (H, W, 3) uint8 in BGR order, grey replicated into
the three channels, the EXIF orientation applied. It reads baseline,
extended-sequential and progressive files, Huffman- or arithmetic-coded,
with one, three or four components (CMYK, or YCCK by the Adobe marker,
turned into BGR as OpenCV does); lossless files of 2- to 8-bit precision
that are RGB or CMYK (libjpeg-turbo converts no colour space for lossless
data, so imread returns None for grey, YCbCr and YCCK ones), their samples
as the file holds them; and files cut short as libjpeg's stdio source reads
them: the data after the cut decodes as zero bits (zero bytes, arithmetic)
of an inserted EOI marker, and a progressive file's coefficients that are
not fully known are estimated by libjpeg's block smoothing. The entropy
decoding and the back end (dequantisation, the islow IDCT as libjpeg-turbo's
SIMD computes it, fancy upsampling, the colour conversions) are the C++ of
`csrc/jpeg_decode.cpp`, built for the host by `ops._build.load_host`; they
follow libjpeg-turbo step for step in integer arithmetic, so the pixels are
OpenCV's bit for bit. Hierarchical, 12-bit and lossless arithmetic-coded
files, the lossless files above, 2-component files, files that end before
their first scan (where `imread` returns nothing for each) and files of more
than 2**30 pixels (which OpenCV refuses too) raise `ValueError` naming the
file and the reason. `decode_jpeg` reads bytes as `read_jpeg` reads a file
holding them (`cv2.imdecode` returns nothing on a cut-short buffer, where
`imread` of the file decodes it). One code path: no file is handed to
OpenCV or PIL.

`compress_roundtrip` is PIL's `Image.save(format="JPEG", quality=q)`
followed by `Image.open(...).convert("RGB")`, returned in BGR order: the
encoder's lossy half at PIL's settings (libjpeg-turbo's fixed-point RGB to
YCbCr, 4:2:0 with jcsample.c's alternating bias, the islow forward DCT and
its rounding quantisation on `jpeg_set_quality(q, force_baseline=TRUE)`'s
tables) in numpy, then the decoder's back end on those coefficients. The
entropy coder in between is lossless, so it is left out.
"""

from __future__ import annotations

import struct

import numpy as np

SIGNATURE = b"\xff\xd8\xff"

# csrc/jpeg_decode.cpp's Error codes; where imread returns None, the file names the reason
_ERRORS = {
    1: "not a JPEG file",
    2: "the JPEG data ends before its first scan",
    4: "lossless JPEG files that need a colour conversion (grey, YCbCr, YCCK) are not read "
       "(libjpeg-turbo converts no lossless data, so cv2.imread returns None)",
    5: "hierarchical JPEG files are not read (libjpeg has no decoder for them)",
    6: "lossless arithmetic-coded JPEG files are not read (libjpeg-turbo has no decoder for "
       "them)",
    7: "only 8-bit DCT and 2- to 8-bit lossless JPEG files are read (OpenCV reads through "
       "libjpeg's 8-bit interface)",
    8: "only grey, 3- and 4-component JPEG files are read (not 2 components)",
    9: "JPEG sampling factors whose ratios are not whole are not read",
    10: "corrupt JPEG data",
    11: "bad arguments to the JPEG back end",
    12: "out of memory decoding the JPEG file",
    13: "more than 2**30 pixels (OpenCV's limit)",
}


def _lib():
    from htd_tpu_torch.ops import _build

    return _build.load_host()[0]


def _check(code: int, source: str) -> None:
    if code:
        raise ValueError(f"{source}: {_ERRORS.get(code, f'JPEG error {code}')}")


def exif_orientation(data: bytes) -> int:
    """The EXIF orientation (tag 0x0112 of IFD0) of the file's first APP1
    segment, in either byte order; 1 where there is none or the block is
    malformed or the value lies outside 1-8."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        code = data[pos + 1]
        if code == 0xFF:              # fill byte
            pos += 1
            continue
        if code in (0xD9, 0xDA):      # EOI, SOS: no more header segments
            return 1
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if code == 0xE1:
            return _tiff_orientation(data[pos + 4:pos + 2 + length])
        pos += 2 + length
    return 1


def _tiff_orientation(body: bytes) -> int:
    if body[:6] != b"Exif\x00\x00":
        return 1
    tiff = body[6:]
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    try:
        if order is None or struct.unpack(order + "H", tiff[2:4])[0] != 42:
            return 1
        (ifd,) = struct.unpack(order + "I", tiff[4:8])
        (n,) = struct.unpack(order + "H", tiff[ifd:ifd + 2])
        for i in range(n):
            entry = ifd + 2 + 12 * i
            tag, = struct.unpack(order + "H", tiff[entry:entry + 2])
            if tag == 0x0112:
                (value,) = struct.unpack(order + "H", tiff[entry + 8:entry + 10])
                return value if 1 <= value <= 8 else 1
    except struct.error:
        pass
    return 1


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ApplyExifOrientation: 2-4 flips, 5-8 a transpose and then
    none, a horizontal, both or a vertical flip."""
    if orientation >= 5:
        img = img.transpose(1, 0, 2)
    flips = {2: (slice(None), slice(None, None, -1)), 3: (slice(None, None, -1),) * 2,
             4: (slice(None, None, -1),), 6: (slice(None), slice(None, None, -1)),
             7: (slice(None, None, -1),) * 2, 8: (slice(None, None, -1),)}
    if orientation in flips:
        img = img[flips[orientation]]
    return np.ascontiguousarray(img)


def _decode(data: bytes, source: str) -> np.ndarray:
    lib = _lib()
    buf = np.frombuffer(data, np.uint8)
    hw = np.zeros(2, np.int32)
    _check(lib.htd_jpeg_header(buf.ctypes.data, buf.size, hw.ctypes.data), source)
    out = np.empty((int(hw[0]), int(hw[1]), 3), np.uint8)
    _check(lib.htd_jpeg_decode(buf.ctypes.data, buf.size, out.ctypes.data, int(hw[0]),
                               int(hw[1])), source)
    return _orient(out, exif_orientation(data))


def decode_jpeg(data: bytes) -> np.ndarray:
    """A JPEG file's bytes as (H, W, 3) uint8 BGR, as `cv2.imread(path,
    IMREAD_COLOR)` gives them from a file; raises `ValueError` on what it
    cannot read."""
    return _decode(bytes(data), "JPEG data")


def read_jpeg(path) -> np.ndarray:
    """The JPEG file at `path` as (H, W, 3) uint8 BGR, as `cv2.imread(path,
    IMREAD_COLOR)` gives it; raises `ValueError` naming the file on what it
    cannot read."""
    with open(path, "rb") as f:
        data = f.read()
    return _decode(data, str(path))


# ---------------------------------------------------------------- PIL's round trip

# jcparam.c: Annex K's tables, natural order
_STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_STD_CHROMA = np.full(64, 99, np.int64)
_STD_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66,
                                                               24, 26, 56, 47, 66]


def quant_tables(quality: int):
    """`jpeg_set_quality(quality, force_baseline=TRUE)`'s luminance and
    chrominance tables (natural order)."""
    q = min(max(quality, 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (_STD_LUMA, _STD_CHROMA))


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def _rgb_to_ycc(rgb: np.ndarray):
    """jccolor.c's rgb_ycc_convert (SCALEBITS 16, Cb and Cr rounded with
    0.5 - epsilon)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + offset + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + offset + half - 1) >> 16
    return y, cb, cr


def _fdct_islow(blocks: np.ndarray) -> np.ndarray:
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


def _blocks(plane: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """The (bh * 8, bw * 8) top-left of an edge-padded plane as (bh * bw, 8, 8)."""
    return plane[:bh * 8, :bw * 8].reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)


def _quantize(blocks: np.ndarray, table: np.ndarray) -> np.ndarray:
    """jcdctmgr.c: each coefficient over 8 x its step, rounded half away from 0."""
    coef = _fdct_islow(blocks - 128).reshape(-1, 64)
    d = table * 8
    q = (np.abs(coef) + d // 2) // d
    return (np.sign(coef) * q).astype(np.int16)


def compress_roundtrip(img: np.ndarray, quality: int) -> np.ndarray:
    """PIL's JPEG round trip of a (H, W, 3) uint8 BGR image at `quality`
    (4:2:0), in BGR order."""
    h, w = img.shape[:2]
    luma_q, chroma_q = quant_tables(quality)
    y, cb, cr = _rgb_to_ycc(img[..., ::-1])
    ybh, ybw = -(-h // 8), -(-w // 8)
    ch, cbh, cbw = (h + 1) // 2, -(-((h + 1) // 2) // 8), -(-((w + 1) // 2) // 8)
    # Edge replication as jcprepct.c and jcsample.c do it: luma to whole
    # blocks; chroma's input to whole blocks across and to an even row
    # count, then its downsampled rows to whole blocks.
    y = np.pad(y, ((0, ybh * 8 - h), (0, ybw * 8 - w)), mode="edge")
    coefs = [_quantize(_blocks(y, ybh, ybw), luma_q)]
    bias = np.tile([1, 2], cbw * 4)   # per output column: 1, 2, 1, 2, ...
    for p in (cb, cr):
        p = np.pad(p, ((0, 2 * ch - h), (0, cbw * 16 - w)), mode="edge")
        down = (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2] + bias) >> 2
        down = np.pad(down, ((0, cbh * 8 - ch), (0, 0)), mode="edge")
        coefs.append(_quantize(_blocks(down, cbh, cbw), chroma_q))
    out = np.empty((h, w, 3), np.uint8)
    samp = np.array([2, 2, 1, 1, 1, 1], np.int32)
    qtab = np.concatenate([luma_q, chroma_q, chroma_q]).astype(np.uint16)
    coef = np.ascontiguousarray(np.concatenate([c.reshape(-1) for c in coefs]))
    _check(_lib().htd_jpeg_reconstruct(3, samp.ctypes.data, qtab.ctypes.data, coef.ctypes.data,
                                       coef.size, h, w, 1, out.ctypes.data), "jpeg round trip")
    return out
