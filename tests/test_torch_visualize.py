"""The port's picture path without cv2 (`htd_tpu_torch.utils.visualize`,
`utils/text.py`, `data.jpeg.encode_jpeg`) against OpenCV 5.0.0 and the JAX
package, on the CPU: the JPEG encoder's bytes against `cv2.imencode`,
`rectangle` against `cv2.rectangle`, `put_text` against `cv2.putText` (OpenCV
5 renders its embedded Rubik font), the committed font against the stream in
OpenCV's binary, `draw_detections` against `htd_tpu.utils.visualize`'s, and
the committed manifest of `tests/data/visualize/`."""

import ast
import gzip
import json
import os
import re
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from htd_tpu.utils import visualize as jvis
from htd_tpu_torch.data.jpeg import _forward as jpeg_forward
from htd_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg, read_jpeg, write_jpeg
from htd_tpu_torch.data.png import read_png
from htd_tpu_torch.utils import text as T
from htd_tpu_torch.utils import visualize as pvis
from tests import jpeg_writers as W
from tests import visualize_fixtures as V

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
ENCODE_SIZES = [(1, 1), (2, 3), (7, 5), (17, 33), (37, 53), (40, 56), (427, 640)]
ASCII = "".join(chr(c) for c in range(0x20, 0x7F))
# other scales and thicknesses than draw_detections' (other pixel sizes, and
# weight 600 above thickness 1), all bit-equal to OpenCV 5.0.0's
OTHER_SCALES = [(0.25, 1), (0.4, 1), (0.7, 1), (1.0, 2), (1.5, 1), (2.0, 3), (3.0, 1), (0.9, 4),
                (6.0, 2)]


def _seeded(seed, h, w):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 3 + y) % 256, (y * 2 + 40) % 256, (x + 5 * y) % 256], -1)
    img = np.clip(img + rng.randint(-25, 26, img.shape), 0, 255).astype(np.uint8)
    return img


# ---------------------------------------------------------------- the JPEG encoder

@pytest.mark.parametrize("hw", ENCODE_SIZES, ids=[f"{h}x{w}" for h, w in ENCODE_SIZES])
def test_encoder_bytes_are_cv2s(hw):
    """encode_jpeg's bytes equal cv2.imencode(".jpg")'s at its defaults
    (quality 95, 4:2:0), seeded noise and gradients, 1x1 to photo size;
    odd sizes exercise the last MCU's dummy blocks."""
    for seed in (0, 1):
        img = _seeded(seed + hw[0], *hw)
        if seed:
            img = np.random.RandomState(seed).randint(0, 256, img.shape).astype(np.uint8)
        assert encode_jpeg(img) == cv2.imencode(".jpg", img)[1].tobytes()


@pytest.mark.parametrize("quality", [5, 50, 95, 100])
def test_forward_half_matches_numpy_reference(quality):
    """The C++ forward half (colour conversion, downsampling, islow DCT,
    quantisation) gives the numpy reference's blocks, at odd sizes too."""
    for hw in ENCODE_SIZES[:-1] + [(33, 1), (1, 40), (16, 16)]:
        img = _seeded(quality + hw[1], *hw)
        got, want = jpeg_forward(img, quality), W.forward_reference(img, quality)
        assert len(got[0]) == len(want[0])
        for g, r in zip(got[0] + list(got[1:]), want[0] + list(want[1:])):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("quality", [5, 50, 75, 100])
def test_encoder_qualities(quality):
    img = _seeded(3, 19, 29)
    assert encode_jpeg(img, quality) == cv2.imencode(
        ".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()


def test_encoder_on_photo0():
    img = cv2.imread(str(V.JPEG_ROOT / "photo0.jpg"))
    assert encode_jpeg(img) == cv2.imencode(".jpg", img)[1].tobytes()


def test_write_jpeg_reads_back_as_cv2s_file(tmp_path):
    """write_jpeg's file is cv2.imwrite's, byte for byte, and read_jpeg of
    it equals cv2.imread of cv2's own file."""
    img = _seeded(7, 45, 38)
    ours, theirs = tmp_path / "ours.jpg", tmp_path / "theirs.jpg"
    write_jpeg(ours, img)
    cv2.imwrite(str(theirs), img)
    assert ours.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(read_jpeg(ours), cv2.imread(str(theirs)))


def test_encoder_refuses_what_cv2_would_not_write():
    with pytest.raises(ValueError):
        encode_jpeg(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError):
        encode_jpeg(np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError):
        encode_jpeg(np.zeros((4, 4), np.uint8))


def test_encode_manifest():
    """The committed cv2.imencode hashes (what phase 28 (a) holds the card's
    host to): each fixture decoded by read_jpeg, encoded, and decoded back."""
    manifest = json.loads((V.ROOT / "manifest.json").read_text())["encode"]
    assert len(manifest) == len(V.encode_fixtures())
    for name, want in manifest.items():
        img = read_jpeg(V.JPEG_ROOT / name)
        data = encode_jpeg(img)
        assert [list(img.shape), V.sha256(data), V.sha256(decode_jpeg(data))] == \
            [want["shape"], want["sha256"], want["decoded_sha256"]], name


# ---------------------------------------------------------------- rectangle

def _rect_cases(seed, n):
    rng = np.random.RandomState(seed)
    cases = [((1, 1), (0, 0), (0, 0)), ((1, 1), (-3, -3), (3, 3)), ((5, 7), (6, 4), (-1, 0)),
             ((9, 9), (4, 4), (4, 4)), ((9, 9), (2, 5), (7, 5)), ((9, 9), (2, 1), (2, 8)),
             ((20, 30), (-100000, -5), (100000, 12)), ((20, 30), (35, 25), (40, 30)),
             ((20, 30), (29, 19), (0, 0)), ((1, 40), (-2, 0), (50, 0))]
    for _ in range(n):
        h, w = rng.randint(1, 40, 2)
        p = rng.randint(-15, 55, 4)
        if rng.rand() < 0.2:
            p[2] = p[0]
        if rng.rand() < 0.2:
            p[3] = p[1]
        cases.append(((int(h), int(w)), (int(p[0]), int(p[1])), (int(p[2]), int(p[3]))))
    return cases


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("thickness", [1, 2])
def test_rectangle_is_cv2s(thickness, channels):
    """rectangle equals cv2.rectangle bit for bit at LINE_8: corners
    outside the image or negative, x1 > x2, zero width or height, one-pixel
    images, on seeded backgrounds and colours."""
    rng = np.random.RandomState(thickness * 10 + channels)
    for (h, w), p1, p2 in _rect_cases(thickness + channels, 400):
        shape = (h, w, 3) if channels == 3 else (h, w)
        img = rng.randint(0, 256, shape).astype(np.uint8)
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        want = cv2.rectangle(img.copy(), p1, p2, color, thickness)
        got = pvis.rectangle(img.copy(), p1, p2, color, thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"{(h, w)} {p1} {p2}")


def test_rectangle_takes_thickness_1_and_2():
    with pytest.raises(ValueError):
        pvis.rectangle(np.zeros((4, 4, 3), np.uint8), (0, 0), (2, 2), (1, 2, 3), 3)


# ---------------------------------------------------------------- text

def _text_pair(img, text, org, color):
    want = img.copy()
    cv2.putText(want, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1, cv2.LINE_AA)
    got = T.put_text(img.copy(), text, org, 0.5, color, 1)
    return got, want


def test_put_text_ascii():
    """Every printable ASCII character alone and all of them in six
    strings, at draw_detections' scale 0.5 and thickness 1, white on black
    and a colour on seeded noise: bit-equal to cv2.putText."""
    rng = np.random.RandomState(1)
    for text in list(ASCII) + [ASCII[i:i + 16] for i in range(0, 95, 16)]:
        for color, img in (((255, 255, 255), np.zeros((30, 200, 3), np.uint8)),
                           ((17, 200, 90), rng.randint(0, 256, (30, 200, 3)).astype(np.uint8))):
            got, want = _text_pair(img, text, (3, 20), color)
            np.testing.assert_array_equal(got, want, err_msg=repr(text))


@pytest.mark.parametrize("scale,thickness", OTHER_SCALES)
def test_put_text_other_scales(scale, thickness):
    """The printable ASCII characters in six strings at other scales and
    thicknesses: bit-equal to cv2.putText (the glyphs' positions, their
    instance and their coverage)."""
    for text in [ASCII[i:i + 16] for i in range(0, 95, 16)]:
        img = np.zeros((int(60 * scale) + 30, int(480 * scale) + 40, 3), np.uint8)
        org = (3, int(40 * scale) + 10)
        want = cv2.putText(img.copy(), text, org, cv2.FONT_HERSHEY_SIMPLEX, scale,
                           (255, 255, 255), thickness, cv2.LINE_AA)
        got = T.put_text(img.copy(), text, org, scale, (255, 255, 255), thickness)
        np.testing.assert_array_equal(got, want, err_msg=repr(text))


@pytest.mark.parametrize("scale,thickness", [(6.0, 2), (16.0, 1)])
def test_put_text_large_glyphs(scale, thickness):
    """Each printable character alone at 162 px in weight 600 and at 432 px
    in weight 400, where a heavy outline reaches past the stored glyph box
    (the box's sides move with the phantom points): bit-equal to
    cv2.putText."""
    size = T.legacy_instance(scale, thickness)[0]
    img = np.zeros((2 * size, 2 * size, 3), np.uint8)
    for c in range(0x21, 0x7F):
        got, want = img.copy(), img.copy()
        org = (size // 4, size + size // 4)
        cv2.putText(want, chr(c), org, cv2.FONT_HERSHEY_SIMPLEX, scale, (255, 255, 255),
                    thickness, cv2.LINE_AA)
        T.put_text(got, chr(c), org, scale, (255, 255, 255), thickness)
        np.testing.assert_array_equal(got, want, err_msg=chr(c))


def test_advances_are_opencvs():
    """Each printable character's pen move (advance_pixels of glyph's
    advance) equals the position cv2.putText's FontFace overload returns,
    at sizes 8-70 and weights 400 and 600."""
    font = T.load_font()
    face = cv2.FontFace("sans")
    for weight in (400, 600):
        for size in range(8, 71, 3):
            for c in range(0x20, 0x7F):
                pen = cv2.putText(np.zeros((4, 4, 3), np.uint8), chr(c), (0, 2), (255, 255, 255),
                                  face, size, weight)[0][0]
                advance = T.glyph(font.cmap[c], weight)[3]
                assert T.advance_pixels(advance, size, font.ascent) == pen, (chr(c), size)


def test_put_text_coco_labels():
    """COCO's 80 names with scores as draw_detections writes them, in the
    box's colour, on seeded noise, at origins inside, partly outside and
    past the image's edges: bit-equal to cv2.putText."""
    rng = np.random.RandomState(2)
    for i, name in enumerate(V.COCO_CLASSES):
        text = f"{name} {rng.rand():.2f}"
        color = tuple(int(c) for c in np.random.RandomState(i).randint(60, 255, 3))
        for org in [(5, 20), (-7, 10), (120, 62), (150, 300), (-40, -2)]:
            img = rng.randint(0, 256, (64, 160, 3)).astype(np.uint8)
            got, want = _text_pair(img, text, org, color)
            np.testing.assert_array_equal(got, want, err_msg=f"{text!r} at {org}")


def test_put_text_grey_and_clipped_images():
    rng = np.random.RandomState(3)
    for shape in [(12, 20), (1, 1), (5, 300)]:
        img = rng.randint(0, 256, shape).astype(np.uint8)
        got, want = _text_pair(img, "dog 0.97", (0, 9), (200, 10, 10))
        np.testing.assert_array_equal(got, want)


def test_put_text_control_characters_and_refusals():
    """Control characters (U+0001-U+001F but the line feed, U+007F-U+009F)
    are drawn as "?", as cv2.putText draws them; characters OpenCV would
    take from its unicode font, the NUL and the line feed raise."""
    img = np.zeros((24, 120, 3), np.uint8)
    for c in list(range(1, 10)) + list(range(11, 32)) + [0x7F, 0x85, 0x9F]:
        got, want = _text_pair(img, f"a{chr(c)}b", (2, 16), (255, 255, 255))
        np.testing.assert_array_equal(got, want, err_msg=hex(c))
    for text in ("caf\u00e9 \u4e00", "a\nb", "a\x00b", "\U0001F600", "\u00a0"):
        if all(ord(ch) in T.load_font().cmap for ch in text):
            continue
        with pytest.raises(ValueError, match="Rubik"):
            T.put_text(img.copy(), text, (0, 15), 0.5, (1, 2, 3))


def test_legacy_instance():
    """cv2 5.0's map of FONT_HERSHEY_SIMPLEX's scale and thickness onto
    FontFace("sans")'s pixel size and weight, as probed."""
    for scale, thickness in [(0.5, 1), (1.0, 2), (0.35, 1), (1.5, 3), (0.55, 0)]:
        size, weight = T.legacy_instance(scale, thickness)
        a = np.zeros((60, 200, 3), np.uint8)
        b = a.copy()
        cv2.putText(a, "Ag 0.5", (4, 40), cv2.FONT_HERSHEY_SIMPLEX, scale, (255, 255, 255),
                    thickness, cv2.LINE_AA)
        cv2.putText(b, "Ag 0.5", (4, 40), (255, 255, 255), cv2.FontFace("sans"), size, weight)
        np.testing.assert_array_equal(a, b)


def _cv2_font_stream() -> bytes:
    """The gzip stream of "Rubik.ttf" in OpenCV's binary, found by its
    gzip header and file name."""
    binary = Path(cv2.__file__).with_name("cv2.abi3.so")
    if not binary.exists():
        binary = next(Path(cv2.__file__).parent.glob("cv2*.so"))
    data = binary.read_bytes()
    start = data.find(b"\x1f\x8b\x08\x08")
    while start >= 0 and data[start + 10:start + 20] != b"Rubik.ttf\x00":
        start = data.find(b"\x1f\x8b\x08\x08", start + 1)
    assert start >= 0, "no Rubik.ttf stream in OpenCV's binary"
    import zlib

    d = zlib.decompressobj(31)
    d.decompress(data[start:])
    return data[start:len(data) - len(d.unused_data)]


def test_font_is_opencvs_stream():
    """The committed font is OpenCV 5's embedded upright Rubik, byte for
    byte (still gzipped), and reads as a variable TrueType font."""
    committed = T.FONT_PATH.read_bytes()
    assert committed == _cv2_font_stream()
    font = T.Font(gzip.decompress(committed))
    assert font.axes == [("wght", 300.0, 300.0, 900.0)] and font.ascent == 935
    assert (T.FONT_PATH.parent / "NOTICE").read_text().count("SIL Open Font License") >= 1


@pytest.mark.parametrize("weight", [300, 400, 600, 900])
def test_font_variations_match_fonttools(weight):
    """Glyph outlines at a weight (gvar deltas summed, before OpenCV's
    flooring) and the phantom points' advance against fontTools' instancer
    (whose advance comes from HVAR: equal for every glyph with an outline)."""
    fonttools = pytest.importorskip("fontTools.ttLib")
    from fontTools.varLib.instancer import instantiateVariableFont

    data = gzip.decompress(T.FONT_PATH.read_bytes())
    import io

    ref_deltas = fonttools.TTFont(io.BytesIO(data))["gvar"].variations
    ref = instantiateVariableFont(fonttools.TTFont(io.BytesIO(data)), {"wght": weight})
    font = T.load_font()
    coords = font.normalize({"wght": weight})
    order = ref.getGlyphOrder()
    for c in range(0x21, 0x7F):
        gid = font.cmap[c]
        xs, ys, on, ends, _ = font.simple_glyph(gid)
        dx, dy = font.glyph_deltas(gid, coords, xs, ys, ends)
        n = len(xs)
        want = np.asarray(ref["glyf"][order[gid]].getCoordinates(ref["glyf"])[0])
        got = np.stack([np.add(xs, dx[:n]), np.add(ys, dy[:n])], 1)
        # points whose deltas IUP infers: whole units here (see test_iup_matches_fonttools)
        inferred = np.zeros(n, bool)
        for var in ref_deltas.get(order[gid], []):
            inferred |= np.array([c is None for c in var.coordinates[:n]])
        np.testing.assert_allclose(got[~inferred], want[~inferred], atol=1e-9)
        assert (np.abs(got[inferred] - want[inferred]) < 1).all()
        adv = font.hmetrics(gid)[0] + dx[n + 1] - dx[n]
        assert int(np.floor(adv + 0.5)) == ref["hmtx"][order[gid]][0]   # otRound


def test_iup_matches_fonttools():
    """gvar's IUP step (untouched points inferred from the touched ones
    around them) on seeded contours against fontTools' iup_delta: equal where
    that is a whole number of units, else within one unit (the port keeps
    whole units, as OpenCV does: the grave accent's inferred deltas 39.16 and
    39.39 are 39 in its weight 500 and 600 outlines)."""
    iup = pytest.importorskip("fontTools.varLib.iup")
    rng = np.random.RandomState(4)
    for _ in range(200):
        ends = np.cumsum(rng.randint(1, 9, rng.randint(1, 4))) - 1
        n = int(ends[-1]) + 1
        xs, ys = rng.randint(-50, 50, n), rng.randint(-50, 50, n)
        touched = rng.rand(n) < 0.5
        points = [int(i) for i in np.nonzero(touched)[0]]
        tx, ty = rng.randint(-20, 20, len(points)), rng.randint(-20, 20, len(points))
        dx, dy = T._iup(xs, ys, ends.tolist(), points, tx, ty, n + 4)
        deltas = [None] * n + [(0, 0)] * 4       # fontTools wants the phantom points too
        for p, a, b in zip(points, tx, ty):
            deltas[p] = (int(a), int(b))
        coords = list(zip(xs.tolist(), ys.tolist())) + [(0, 0)] * 4
        want = np.asarray(iup.iup_delta(deltas, coords, ends.tolist()), float).reshape(-1, 2)
        got = np.stack([dx[:n], dy[:n]], 1)
        whole = want[:n] == np.round(want[:n])
        np.testing.assert_array_equal(got[whole], want[:n][whole])
        assert (np.abs(got - want[:n]) < 1).all()


# ---------------------------------------------------------------- draw_detections, imwrite

def _detections(seed, h, w, n=40):
    rng = np.random.RandomState(seed)
    x1, y1 = rng.uniform(-30, w, n), rng.uniform(-30, h, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(0, 150, n), y1 + rng.uniform(0, 120, n)], 1)
    boxes[:3] = [[0.5, 1.5, w - 0.5, h + 3], [w / 2, h / 2, w / 2, h / 2], [-9, -9, 2.5, 2.5]]
    return (boxes.astype(np.float32), rng.uniform(0, 1, n).astype(np.float32),
            rng.randint(0, 80, n))


@pytest.mark.parametrize("names", [True, False], ids=["coco-names", "label-numbers"])
def test_draw_detections_matches_jax(names, tmp_path):
    """Pixels and written files (.jpg by bytes, .png by pixels) of
    draw_detections against the JAX package's on a seeded image."""
    img = _seeded(5, 120, 180)
    boxes, scores, labels = _detections(6, 120, 180)
    classes = V.COCO_CLASSES if names else None
    for ext in (".jpg", ".png", ".jpeg"):
        want = jvis.draw_detections(img, boxes, scores, labels, classes, 0.3,
                                    str(tmp_path / f"jax{ext}"))
        got = pvis.draw_detections(img, boxes, scores, labels, classes, 0.3,
                                   str(tmp_path / f"port{ext}"))
        np.testing.assert_array_equal(got, want)
        if ext == ".png":
            np.testing.assert_array_equal(read_png(tmp_path / "port.png"),
                                          cv2.imread(str(tmp_path / "jax.png")))
        else:
            assert (tmp_path / f"port{ext}").read_bytes() == (tmp_path / f"jax{ext}").read_bytes()
    np.testing.assert_array_equal(pvis.draw_detections(img, boxes, scores, labels),
                                  jvis.draw_detections(img, boxes, scores, labels))


def test_draw_manifest(tmp_path):
    """The committed detections on photo0 against the JAX package's hashes
    (what phase 28 (b) holds the card's host to)."""
    manifest = json.loads((V.ROOT / "manifest.json").read_text())["draw"]
    name, boxes, scores, labels, classes = V.load_detections()
    out = tmp_path / "drawn.jpg"
    got = pvis.draw_detections(read_jpeg(V.JPEG_ROOT / name), boxes, scores, labels, classes,
                               manifest["score_thr"], str(out))
    assert V.sha256(got) == manifest["pixels_sha256"]
    assert V.sha256(out.read_bytes()) == manifest["jpg_sha256"]


def test_imwrite_picks_the_writer_by_extension(tmp_path):
    img = _seeded(8, 10, 14)
    pvis.imwrite(tmp_path / "a.JPE", img)
    assert (tmp_path / "a.JPE").read_bytes() == cv2.imencode(".jpg", img)[1].tobytes()
    pvis.imwrite(tmp_path / "a.png", img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png")), img)
    for ext in (".bmp", ".tif", ".webp", ""):
        with pytest.raises(ValueError, match="imwrite"):
            pvis.imwrite(tmp_path / f"a{ext}", img)


def test_port_imports_no_cv2_pil_or_jax():
    """No module of htd_tpu_torch or tools_torch imports cv2, PIL, jax,
    flax or the JAX package."""
    banned = {"cv2", "PIL", "jax", "flax", "htd_tpu"}
    bad = []
    for pkg in ("htd_tpu_torch", "tools_torch"):
        for path in sorted((REPO / pkg).rglob("*.py")):
            for node in ast.walk(ast.parse(path.read_text())):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                    names = [node.module]
                bad += [f"{path.relative_to(REPO)}: {n}" for n in names
                        if n.split(".")[0] in banned]
            text = path.read_text()
            bad += [f"{path.relative_to(REPO)}: {m}" for m in
                    re.findall(r"import_module\(['\"](cv2|PIL|jax)", text)]
    assert not bad, bad
    assert os.path.exists(REPO / "htd_tpu_torch" / "utils" / "visualize.py")
