"""Text on images as OpenCV 5's `cv2.putText` draws it, without OpenCV.

OpenCV 5 no longer draws the Hershey strokes: `putText(img, text, org,
FONT_HERSHEY_SIMPLEX, scale, color, thickness, lineType)` renders its
embedded variable TrueType font "Rubik for OpenCV" (its upright stream is
`fonts/Rubik.ttf.gz`, byte for byte) through a copy of stb_truetype. This
module reads the font (`cmap`, `loca`, `glyf`, `hmtx`, and the variation
tables `fvar`, `avar` and `gvar` with IUP), picks the instance and pixel
size the legacy call maps to, and hands each glyph's outline to the host
library (`csrc/text_raster.cpp`), which flattens, rasterises and blends it as
OpenCV does. What was fitted against OpenCV 5.0.0, by probing its output:

- the legacy call is `putText(..., FontFace("sans"), size, weight)` with
  size `floor(27 * scale + 0.5)` pixels and weight 400 for thickness 1 or
  less, 600 above; `lineType` is ignored (the text is always anti-aliased);
- the instance's glyph points are the stored ones plus the summed `gvar`
  deltas, floored to whole font units; the glyph's box is the stored one
  (the glyf header's), its sides moved with the horizontal phantom points;
  its advance is the distance of its two horizontal phantom points, varied
  and floored the same way; a glyph without an outline (the space) keeps
  its stored advance at every weight, though `gvar` and `HVAR` vary it
  (`HVAR` is not read);
- one pixel of size is `1 / hhea.ascent` font units (935 for Rubik);
- each glyph's bitmap lies at the integer pen position; the pen then moves by
  `advance_pixels`: the advance in whole font units scaled, rounded to 1/64
  pixel, then floored to whole pixels; no kerning, no sub-pixel positions;
  `org` is the baseline's left end;
- coverage is stb_truetype's exact-area rasteriser on curves flattened to
  0.35 pixel, in the glyph's box padded as OpenCV pads it (read off its
  machine code: max(ceil(w / 10), ceil(h / 10)) + 10 pixels a side, the
  outline shifted by the padding, which changes the float32 rounding of the
  edges), and the colour is blended as round((dst * (255 - a) + color *
  a) / 255) per channel, clipped to the image.

Control characters are drawn as "?", as OpenCV draws them (neither of its
fonts has them). Other characters the font lacks are not drawn: OpenCV would
look them up in its 4.5 MB unicode font, which is not ported, and draw "?"
where that lacks them too, so `put_text` raises for them, and for the NUL
and line feed, which OpenCV takes as the end of the text and a new line.
"""

from __future__ import annotations

import functools
import gzip
import struct
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

FONT_PATH = Path(__file__).resolve().parent / "fonts" / "Rubik.ttf.gz"


def _f2dot14(v: int) -> float:
    return v / 16384.0


class Font:
    """A TrueType font with glyph variations, read from its bytes."""

    def __init__(self, data: bytes):
        self.data = data
        num_tables = struct.unpack_from(">H", data, 4)[0]
        self.tables: Dict[str, Tuple[int, int]] = {}
        for i in range(num_tables):
            tag, _, off, length = struct.unpack_from(">4sIII", data, 12 + 16 * i)
            self.tables[tag.decode("latin-1")] = (off, length)
        self.long_loca = struct.unpack_from(">h", data, self._table("head") + 50)[0] == 1
        hhea = self._table("hhea")
        self.ascent = struct.unpack_from(">h", data, hhea + 4)[0]
        self.num_hmetrics = struct.unpack_from(">H", data, hhea + 34)[0]
        self.cmap = self._read_cmap()
        self.axes = self._read_fvar()
        self.avar = self._read_avar()

    def _table(self, tag: str) -> int:
        return self.tables[tag][0]

    # ---------------------------------------------------------------- cmap
    def _read_cmap(self) -> Dict[int, int]:
        data, base = self.data, self._table("cmap")
        n = struct.unpack_from(">H", data, base + 2)[0]
        sub = None
        for i in range(n):
            pid, eid, off = struct.unpack_from(">HHI", data, base + 4 + 8 * i)
            if (pid, eid) in ((3, 1), (0, 3)) and struct.unpack_from(">H", data, base + off)[0] == 4:
                sub = base + off
                if pid == 3:
                    break
        if sub is None:
            raise ValueError("the font has no format-4 Unicode cmap")
        seg2 = struct.unpack_from(">H", data, sub + 6)[0]
        segs = seg2 // 2
        ends = struct.unpack_from(f">{segs}H", data, sub + 14)
        starts = struct.unpack_from(f">{segs}H", data, sub + 16 + seg2)
        deltas = struct.unpack_from(f">{segs}h", data, sub + 16 + 2 * seg2)
        ro_pos = sub + 16 + 3 * seg2
        ranges = struct.unpack_from(f">{segs}H", data, ro_pos)
        out = {}
        for i in range(segs):
            for c in range(starts[i], ends[i] + 1):
                if c == 0xFFFF:
                    continue
                if ranges[i] == 0:
                    g = (c + deltas[i]) & 0xFFFF
                else:
                    pos = ro_pos + 2 * i + ranges[i] + 2 * (c - starts[i])
                    g = struct.unpack_from(">H", data, pos)[0]
                    if g:
                        g = (g + deltas[i]) & 0xFFFF
                if g:
                    out[c] = g
        return out

    # ---------------------------------------------------------------- axes
    def _read_fvar(self) -> List[Tuple[str, float, float, float]]:
        if "fvar" not in self.tables:
            return []
        data, base = self.data, self._table("fvar")
        axes_off, _, count, size = struct.unpack_from(">HHHH", data, base + 4)
        axes = []
        for i in range(count):
            tag, lo, default, hi = struct.unpack_from(">4siii", data, base + axes_off + size * i)
            axes.append((tag.decode("latin-1"), lo / 65536, default / 65536, hi / 65536))
        return axes

    def _read_avar(self) -> List[List[Tuple[float, float]]]:
        if "avar" not in self.tables:
            return [[] for _ in self.axes]
        data, pos = self.data, self._table("avar") + 8
        maps = []
        for _ in self.axes:
            (n,) = struct.unpack_from(">H", data, pos)
            pairs = struct.unpack_from(f">{2 * n}h", data, pos + 2)
            maps.append([(_f2dot14(pairs[2 * j]), _f2dot14(pairs[2 * j + 1])) for j in range(n)])
            pos += 2 + 4 * n
        return maps

    def normalize(self, values: Dict[str, float]) -> Tuple[float, ...]:
        """User axis values to normalised coordinates: the default-min-max
        map, then `avar`, each rounded to F2Dot14 as the specification
        says."""
        coords = []
        for (tag, lo, default, hi), segs in zip(self.axes, self.avar):
            v = min(max(values.get(tag, default), lo), hi)
            if v < default:
                n = -(default - v) / (default - lo)
            elif v > default:
                n = (v - default) / (hi - default)
            else:
                n = 0.0
            n = round(n * 16384) / 16384
            for (f0, t0), (f1, t1) in zip(segs, segs[1:]):
                if f0 <= n <= f1:
                    n = t0 if f1 == f0 else t0 + (n - f0) * (t1 - t0) / (f1 - f0)
                    break
            coords.append(round(n * 16384) / 16384)
        return tuple(coords)

    # ---------------------------------------------------------------- glyphs
    def _glyph_range(self, gid: int) -> Tuple[int, int]:
        loca = self._table("loca")
        if self.long_loca:
            a, b = struct.unpack_from(">II", self.data, loca + 4 * gid)
        else:
            a, b = (2 * v for v in struct.unpack_from(">HH", self.data, loca + 2 * gid))
        return a, b

    def hmetrics(self, gid: int) -> Tuple[int, int]:
        hmtx = self._table("hmtx")
        if gid < self.num_hmetrics:
            return struct.unpack_from(">Hh", self.data, hmtx + 4 * gid)
        (adv,) = struct.unpack_from(">H", self.data, hmtx + 4 * (self.num_hmetrics - 1))
        (lsb,) = struct.unpack_from(">h", self.data,
                                   hmtx + 4 * self.num_hmetrics + 2 * (gid - self.num_hmetrics))
        return adv, lsb

    def simple_glyph(self, gid: int):
        """(x, y, on-curve, contour ends, (xMin, yMin, xMax, yMax)) of a
        simple glyph as stored; None for an empty glyph."""
        a, b = self._glyph_range(gid)
        if a == b:
            return None
        data, g = self.data, self._table("glyf") + a
        n_contours, x0, y0, x1, y1 = struct.unpack_from(">h4h", data, g)
        if n_contours < 0:
            raise ValueError(f"glyph {gid} is a composite glyph, which is not read")
        ends = struct.unpack_from(f">{n_contours}H", data, g + 10)
        n = ends[-1] + 1 if n_contours else 0
        pos = g + 10 + 2 * n_contours
        (ilen,) = struct.unpack_from(">H", data, pos)
        pos += 2 + ilen
        flags = []
        while len(flags) < n:
            f = data[pos]
            pos += 1
            flags.append(f)
            if f & 8:
                flags.extend([f] * data[pos])
                pos += 1
        coords = []
        for short, same in ((2, 16), (4, 32)):
            v, vals = 0, []
            for f in flags:
                if f & short:
                    d = data[pos]
                    pos += 1
                    v += d if f & same else -d
                elif not f & same:
                    (d,) = struct.unpack_from(">h", data, pos)
                    pos += 2
                    v += d
                vals.append(v)
            coords.append(vals)
        on = [f & 1 for f in flags]
        return coords[0], coords[1], on, list(ends), (x0, y0, x1, y1)

    # ---------------------------------------------------------------- variations
    def _tuple_scalar(self, coords, peak, start=None, end=None) -> float:
        scalar = 1.0
        for i, (c, p) in enumerate(zip(coords, peak)):
            if p == 0:
                continue
            if c == 0 or (c < 0) != (p < 0):
                return 0.0
            if start is not None:
                s, e = start[i], end[i]
                if c < s or c > e:
                    return 0.0
                if c < p:
                    scalar *= (c - s) / (p - s) if p != s else 1.0
                elif c > p:
                    scalar *= (e - c) / (e - p) if e != p else 1.0
            elif abs(c) < abs(p):
                scalar *= c / p
        return scalar

    @staticmethod
    def _packed_points(data: bytes, pos: int):
        count = data[pos]
        pos += 1
        if count == 0:
            return None, pos
        if count & 0x80:
            count = ((count & 0x7F) << 8) | data[pos]
            pos += 1
        points, v = [], 0
        while len(points) < count:
            ctrl = data[pos]
            pos += 1
            run = (ctrl & 0x7F) + 1
            for _ in range(run):
                if ctrl & 0x80:
                    (d,) = struct.unpack_from(">H", data, pos)
                    pos += 2
                else:
                    d = data[pos]
                    pos += 1
                v += d
                points.append(v)
        return points, pos

    @staticmethod
    def _packed_deltas(data: bytes, pos: int, count: int):
        out = []
        while len(out) < count:
            ctrl = data[pos]
            pos += 1
            run = (ctrl & 0x3F) + 1
            if ctrl & 0x80:
                out.extend([0] * run)
            elif ctrl & 0x40:
                out.extend(struct.unpack_from(f">{run}h", data, pos))
                pos += 2 * run
            else:
                out.extend(struct.unpack_from(f">{run}b", data, pos))
                pos += run
        return out, pos

    def glyph_deltas(self, gid: int, coords: Tuple[float, ...], xs, ys, ends):
        """The summed gvar deltas (float) of the glyph's points and its four
        phantom points at normalised `coords`, IUP applied to the points a
        tuple leaves out."""
        n = len(xs) + 4
        dx, dy = np.zeros(n), np.zeros(n)
        if "gvar" not in self.tables or not any(coords):
            return dx, dy
        data, base = self.data, self._table("gvar")
        axis_count, shared_count = struct.unpack_from(">HH", data, base + 4)
        (shared_off,) = struct.unpack_from(">I", data, base + 8)
        glyph_count, flags = struct.unpack_from(">HH", data, base + 12)
        (array_off,) = struct.unpack_from(">I", data, base + 16)
        if flags & 1:
            a, b = struct.unpack_from(">II", data, base + 20 + 4 * gid)
        else:
            a, b = (2 * v for v in struct.unpack_from(">HH", data, base + 20 + 2 * gid))
        if a == b:
            return dx, dy
        gv = base + array_off + a
        count, data_off = struct.unpack_from(">HH", data, gv)
        shared = [[_f2dot14(v) for v in struct.unpack_from(f">{axis_count}h", data,
                                                             base + shared_off + 2 * axis_count * i)]
                  for i in range(shared_count)]
        pos, sdata = gv + 4, gv + data_off
        shared_points = None
        if count & 0x8000:
            shared_points, sdata = self._packed_points(data, sdata)
        for _ in range(count & 0x0FFF):
            size, index = struct.unpack_from(">HH", data, pos)
            pos += 4
            if index & 0x8000:
                peak = [_f2dot14(v) for v in struct.unpack_from(f">{axis_count}h", data, pos)]
                pos += 2 * axis_count
            else:
                peak = shared[index & 0x0FFF]
            start = end = None
            if index & 0x4000:
                start = [_f2dot14(v) for v in struct.unpack_from(f">{axis_count}h", data, pos)]
                end = [_f2dot14(v) for v in
                       struct.unpack_from(f">{axis_count}h", data, pos + 2 * axis_count)]
                pos += 4 * axis_count
            body, next_body = sdata, sdata + size
            sdata = next_body
            scalar = self._tuple_scalar(coords, peak, start, end)
            if scalar == 0:
                continue
            points = shared_points
            if index & 0x2000:
                points, body = self._packed_points(data, body)
            m = n if points is None else len(points)
            tx, body = self._packed_deltas(data, body, m)
            ty, body = self._packed_deltas(data, body, m)
            if points is None:
                dx += scalar * np.asarray(tx, float)
                dy += scalar * np.asarray(ty, float)
            else:
                px, py = _iup(xs, ys, ends, points, tx, ty, n)
                dx += scalar * px
                dy += scalar * py
        return dx, dy


def _iup(xs, ys, ends, points, tx, ty, n):
    """A tuple's deltas for all n points (the glyph's and its 4 phantom
    points) from its explicit ones: gvar's IUP step infers each untouched
    point of a contour from the touched points before and after it (cyclic),
    per axis, in whole font units as OpenCV computes it (the interpolation's
    quotient truncated towards zero); phantom points keep their explicit
    deltas only."""
    explicit = np.zeros((n, 2), np.int64)
    touched = np.zeros(n, bool)
    for pt, a, b in zip(points, tx, ty):
        if pt < n:
            explicit[pt] += (a, b)
            touched[pt] = True
    out = np.where(touched[:, None], explicit, 0)
    coords = np.stack([np.asarray(xs, np.int64), np.asarray(ys, np.int64)], 1)
    start = 0
    for end in ends:
        idx = [i for i in range(start, end + 1) if touched[i]]
        m = end + 1 - start
        for k, i in enumerate(idx):
            j = idx[(k + 1) % len(idx)]
            p = start + (i - start + 1) % m
            while p != j:
                for ax in (0, 1):
                    c1, c2 = int(coords[i, ax]), int(coords[j, ax])
                    d1, d2 = int(explicit[i, ax]), int(explicit[j, ax])
                    if c1 > c2:
                        c1, c2, d1, d2 = c2, c1, d2, d1
                    c = int(coords[p, ax])
                    if c1 == c2:
                        out[p, ax] = d1 if d1 == d2 else 0
                    elif c <= c1:
                        out[p, ax] = d1
                    elif c >= c2:
                        out[p, ax] = d2
                    else:
                        num = (c - c1) * (d2 - d1)
                        q = abs(num) // (c2 - c1)
                        out[p, ax] = d1 + (q if num >= 0 else -q)
                p = start + (p - start + 1) % m
        start = end + 1
    return out[:, 0], out[:, 1]


@functools.lru_cache(maxsize=None)
def load_font() -> Font:
    """The upright Rubik that OpenCV 5 embeds, read once per process."""
    return Font(gzip.decompress(FONT_PATH.read_bytes()))


# ---------------------------------------------------------------- drawing

_MOVE, _LINE, _CURVE = 1, 2, 3


def legacy_instance(font_scale: float, thickness: int) -> Tuple[int, int]:
    """The pixel size and weight that OpenCV 5 renders `FONT_HERSHEY_SIMPLEX`
    at `font_scale` and `thickness` with."""
    return int(np.floor(27 * font_scale + 0.5)), (400 if thickness <= 1 else 600)


def _stb_vertices(xs, ys, on, ends):
    """stbtt_GetGlyphShape's conversion of TrueType points (integer units)
    into moves, lines and quadratic curves; implied on-curve points between
    two off-curve ones are the floor of their midpoint."""
    types, verts = [], []

    def add(t, x, y, cx=0, cy=0):
        types.append(t)
        verts.append((x, y, cx, cy))

    start = 0
    for end in ends:
        pts = list(range(start, end + 1))
        start = end + 1
        first = pts[0]
        sx, sy = xs[first], ys[first]
        scx = scy = cx = cy = 0
        start_off = not on[first]
        i0 = 1
        if start_off:
            scx, scy = sx, sy
            nxt = pts[1] if len(pts) > 1 else first
            if not on[nxt]:
                sx, sy = (xs[first] + xs[nxt]) >> 1, (ys[first] + ys[nxt]) >> 1
            else:
                sx, sy = xs[nxt], ys[nxt]
                i0 = 2
        add(_MOVE, sx, sy)
        was_off = False
        for p in pts[i0:]:
            x, y = xs[p], ys[p]
            if not on[p]:
                if was_off:
                    add(_CURVE, (cx + x) >> 1, (cy + y) >> 1, cx, cy)
                cx, cy, was_off = x, y, True
            else:
                if was_off:
                    add(_CURVE, x, y, cx, cy)
                else:
                    add(_LINE, x, y)
                was_off = False
        if start_off:
            if was_off:
                add(_CURVE, (cx + scx) >> 1, (cy + scy) >> 1, cx, cy)
            add(_CURVE, sx, sy, scx, scy)
        elif was_off:
            add(_CURVE, sx, sy, cx, cy)
        else:
            add(_LINE, sx, sy)
    return np.asarray(types, np.int32), np.asarray(verts, np.float32).reshape(-1, 4)


@functools.lru_cache(maxsize=None)
def glyph(gid: int, weight: int):
    """(stb vertex types, vertices, box (x0, y0, x1, y1), advance) of glyph
    `gid` at `weight`, in font units; no vertices for an empty glyph. The box
    is the glyf header's with its left and right sides moved as the varied
    phantom points move, not the varied outline's bounds: OpenCV sizes the
    glyph's bitmap from it (its padding leaves room for the outline)."""
    font = load_font()
    a0, lsb = font.hmetrics(gid)
    shape = font.simple_glyph(gid)
    if shape is None:       # no outline: OpenCV varies nothing, the advance included
        return np.zeros(0, np.int32), np.zeros((0, 4), np.float32), None, a0
    xs, ys, on, ends, box = shape
    # the glyph's points, then the phantom points (xMin - lsb, 0) and
    # (xMin - lsb + advance, 0); gvar varies all of them, and OpenCV floors
    # each to whole units, the advance being the phantom points' distance
    px = np.asarray(list(xs) + [box[0] - lsb, box[0] - lsb + a0, 0, 0], float)
    py = np.asarray(list(ys) + [0, 0, 0, 0], float)
    dx, dy = font.glyph_deltas(gid, font.normalize({"wght": weight}), xs, ys, ends)
    px, py = np.floor(px + dx).astype(int), np.floor(py + dy).astype(int)
    n = len(xs)
    advance = int(px[n + 1] - px[n])
    types, verts = _stb_vertices(px[:n].tolist(), py[:n].tolist(), on, ends)
    # the stored box, its sides moved with the horizontal phantom points
    left, right = px[n] - (box[0] - lsb), px[n + 1] - (box[0] - lsb + a0)
    return types, verts, (box[0] + left, box[1], box[2] + right, box[3]), advance


def advance_pixels(advance: int, size: int, ascent: int) -> int:
    """The pen's move after a glyph of `advance` whole font units: scaled
    to 1/64 pixel and rounded, then floored to whole pixels."""
    return int(np.floor(advance * size / ascent * 64 + 0.5)) >> 6


def _glyph_ids(font: Font, text: str) -> List[int]:
    """The glyph of each character: the font's, or "?" for the control
    characters OpenCV draws as "?" (U+0001-U+001F but the line feed, and
    U+007F-U+009F: neither of its fonts has them). The NUL and line feed
    (which OpenCV treats as the end of the text and a new line) and any
    other character the font lacks raise ValueError."""
    ids = []
    for ch in text:
        c = ord(ch)
        gid = font.cmap.get(c, 0)
        if not gid and (0 < c < 0x20 and c != 0x0A or 0x7F <= c <= 0x9F):
            gid = font.cmap[ord("?")]
        if not gid:
            raise ValueError(f"put_text draws only characters of the embedded Rubik font; "
                             f"{ch!r} is not one (OpenCV would take it from its unicode font, "
                             f"or end the text or the line)")
        ids.append(gid)
    return ids


def put_text(img: np.ndarray, text: str, org, font_scale: float, color,
             thickness: int = 1) -> np.ndarray:
    """Draw `text` into `img` (uint8, (H, W) or (H, W, C), C-contiguous rows)
    in place as OpenCV 5's `cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX,
    font_scale, color, thickness, LINE_AA)` does, and return `img`. `org` is
    the left end of the baseline; `color` has one value per channel."""
    from htd_tpu_torch.ops import _build

    if img.dtype != np.uint8 or img.ndim not in (2, 3) or not img[0].flags.c_contiguous:
        raise ValueError("put_text draws into a uint8 (H, W) or (H, W, C) image with "
                         "contiguous rows")
    font = load_font()
    size, weight = legacy_instance(font_scale, thickness)
    scale = np.float32(size) / np.float32(font.ascent)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    col = np.zeros(max(c, 4), np.int32)
    vals = [color] if np.isscalar(color) else list(color)
    col[:min(c, len(vals))] = [int(round(v)) for v in vals[:c]]
    lib = _build.load_host()[0]
    x, y = int(org[0]), int(org[1])
    for gid in _glyph_ids(font, text):
        types, verts, box, advance = glyph(gid, weight)
        if box is not None:
            x0, y0, x1, y1 = box
            bx = int(np.floor(np.float32(x0) * scale))
            by = int(np.floor(np.float32(-y1) * scale))
            gw = int(np.ceil(np.float32(x1) * scale)) - bx
            gh = int(np.ceil(np.float32(-y0) * scale)) - by
            lib.htd_text_glyph(img.ctypes.data, h, w, c, img.strides[0], types.ctypes.data,
                               verts.ctypes.data, len(types), float(scale), bx, by, gw, gh,
                               x + bx, y + by, col.ctypes.data)
        x += advance_pixels(advance, size, font.ascent)
    return img
