"""The port's JPEG decoder (`htd_tpu_torch.data.jpeg`, C++ built for the
host) against OpenCV's `imdecode` / `imread(IMREAD_COLOR)`, bit for bit, on
seeded images that OpenCV and PIL encode here: every sampling OpenCV
writes, qualities 5-100, odd sizes down to 1x1, restart intervals, PIL's
optimised tables, grey, EXIF orientations 1-8 in both byte orders, and
files of one scan per component written here; the
files it refuses; `CocoDataset.load_image` against the JAX package's; the
two manifests of `tests/data/jpeg/` against cv2 and the JAX package."""

import io
import json
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import probe_image, sha256
from htd_tpu.data import coco as jcoco
from htd_tpu.data import corruptions as jcorr
from htd_tpu_torch.data import coco as pcoco
from htd_tpu_torch.data import corruptions as pcorr
from htd_tpu_torch.data.jpeg import SIGNATURE, decode_jpeg, exif_orientation, read_jpeg
from htd_tpu_torch.ops import _build
from tests import jpeg_fixtures as F

torch.set_num_threads(1)
SIZES = [(1, 1), (2, 3), (7, 5), (16, 16), (17, 33), (61, 40)]


def _cv2(data: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def _assert_decodes_as_cv2(data: bytes) -> None:
    assert data.startswith(SIGNATURE)
    np.testing.assert_array_equal(decode_jpeg(data), _cv2(data))


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("sampling", [444, 422, 420, 440, 411])
def test_cv2_samplings(sampling, restart):
    """OpenCV's files at every sampling it writes, qualities 5, 50 and
    100, odd and even sizes, with and without a restart interval."""
    for i, (h, w) in enumerate(SIZES):
        for q in (5, 50, 100):
            _assert_decodes_as_cv2(F.cv2_jpeg(F.pattern(i, h, w), q, sampling, restart))


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_pil_files(subsampling, optimize):
    """PIL's files at 4:4:4, 4:2:2 and 4:2:0, with its default and its
    optimised Huffman tables."""
    for i, (h, w) in enumerate(SIZES):
        for q in (7, 25, 75, 95):
            _assert_decodes_as_cv2(F.pil_jpeg(F.pattern(i, h, w), quality=q,
                                              subsampling=subsampling, optimize=optimize))


def test_grey():
    """One-component files (OpenCV's and PIL's) come out as three equal
    channels, as IMREAD_COLOR gives them."""
    for i, (h, w) in enumerate(SIZES):
        grey = cv2.cvtColor(F.pattern(i, h, w), cv2.COLOR_BGR2GRAY)
        ok, enc = cv2.imencode(".jpg", grey, [cv2.IMWRITE_JPEG_QUALITY, 60])
        _assert_decodes_as_cv2(enc.tobytes())
        _assert_decodes_as_cv2(F.pil_jpeg(grey, quality=30))


@pytest.mark.parametrize("options", [{}, {"subsampled": False}, {"restart": 2},
                                     {"q16": True}, {"requant": True},
                                     {"restart": 1, "subsampled": False, "quality": 20}])
def test_separate_scans(options):
    """Files with one scan per component (written here, which neither cv2
    nor PIL does): 4:2:0 and 4:4:4, restart intervals, 16-bit quantisation
    tables, and a table redefined between two scans (each component keeps
    the table of its first scan)."""
    for i, (h, w) in enumerate(SIZES):
        _assert_decodes_as_cv2(F.separate_scans(F.pattern(i, h, w), **options))


@pytest.mark.parametrize("big_endian", [False, True])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation(orientation, big_endian):
    """IMREAD_COLOR applies the EXIF orientation: the flips and transposes
    of values 1-8, read in either TIFF byte order."""
    data = F.with_exif(F.cv2_jpeg(F.pattern(orientation, 20, 36), 85), orientation, big_endian)
    assert exif_orientation(data) == orientation
    out = decode_jpeg(data)
    assert out.shape == ((36, 20, 3) if orientation >= 5 else (20, 36, 3))
    np.testing.assert_array_equal(out, _cv2(data))


@pytest.mark.parametrize("case", ["no Exif header", "bad byte order", "IFD past the end",
                                  "value 9"])
def test_malformed_exif_is_ignored(case):
    """A malformed EXIF block leaves the image as it is, as cv2 does."""
    plain = F.cv2_jpeg(F.pattern(3, 20, 36), 85)
    seg = bytearray(F.exif_app1(9 if case == "value 9" else 6, False))
    if case == "no Exif header":
        seg[4:8] = b"Exix"
    elif case == "bad byte order":
        seg[10:12] = b"IM"
    elif case == "IFD past the end":
        seg[14:18] = (4000).to_bytes(4, "little")
    data = plain[:2] + bytes(seg) + plain[2:]
    assert exif_orientation(data) == 1
    np.testing.assert_array_equal(decode_jpeg(data), _cv2(data))
    np.testing.assert_array_equal(decode_jpeg(data), decode_jpeg(plain))


def test_refuses_what_it_cannot_read(tmp_path):
    """Progressive files (OpenCV's and PIL's), truncated data and files that
    are not JPEG raise ValueError naming the file."""
    img = F.pattern(0, 32, 48)
    for k, data in enumerate([F.cv2_jpeg(img, 80, progressive=True),
                              F.pil_jpeg(img, quality=80, progressive=True)]):
        path = tmp_path / f"p{k}.jpg"
        path.write_bytes(data)
        with pytest.raises(ValueError, match=rf"p{k}\.jpg: progressive"):
            read_jpeg(path)
    data = F.cv2_jpeg(F.pattern(1, 40, 56), 90)
    sos = data.index(b"\xff\xda")
    for cut in (sos + 20, (sos + len(data)) // 2, len(data) - 40, 100):
        path = tmp_path / f"cut{cut}.jpg"
        path.write_bytes(data[:cut])
        with pytest.raises(ValueError, match=rf"cut{cut}\.jpg: truncated"):
            read_jpeg(path)
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG\r\n\x1a\n")


@pytest.mark.parametrize("case,message", [
    ("SOF9", "arithmetic"), ("SOF3", "lossless"), ("SOF5", "hierarchical"),
    ("12-bit", "only 8-bit"), ("CMYK", "3-component"), ("65535x65535", "2\\*\\*30")])
def test_refuses_other_kinds(case, message):
    """Each kind of file the decoder does not read has its own message:
    baseline files whose frame header says otherwise, PIL's CMYK file, a
    frame over OpenCV's 2**30-pixel limit (which cv2 refuses too)."""
    if case == "CMYK":
        buf = io.BytesIO()
        Image.fromarray(F.pattern(0, 16, 24)).convert("CMYK").save(buf, "JPEG")
        data = buf.getvalue()
    else:
        data = bytearray(F.cv2_jpeg(F.pattern(0, 16, 24), 80))
        sof = data.index(b"\xff\xc0")
        if case.startswith("SOF"):
            data[sof + 1] = 0xC0 + int(case[3:])
        elif case == "12-bit":
            data[sof + 4] = 12
        else:
            data[sof + 5:sof + 9] = b"\xff\xff\xff\xff"
            assert _cv2(bytes(data)) is None
        data = bytes(data)
    with pytest.raises(ValueError, match=message):
        decode_jpeg(data)


def _jpeg_coco(root):
    """Five JPEG files (OpenCV's and PIL's, one with EXIF orientation 6) and
    their annotation file."""
    files = {"a.jpg": F.cv2_jpeg(F.pattern(1, 60, 90), 90),
             "b.jpg": F.pil_jpeg(F.pattern(2, 90, 60), quality=40),
             "c.jpg": F.cv2_jpeg(F.pattern(3, 33, 47), 70, 422, restart=1),
             "d.jpg": F.with_exif(F.cv2_jpeg(F.pattern(4, 40, 70), 80), 6),
             "e.jpg": F.pil_jpeg(F.pattern(5, 25, 25)[..., 0], quality=60)}
    images = []
    for i, (name, data) in enumerate(files.items()):
        (root / name).write_bytes(data)
        h, w = _cv2(data).shape[:2]
        images.append(dict(id=i + 1, file_name=name, height=h, width=w))
    ann = root / "ann.json"
    ann.write_text(json.dumps(dict(images=images, annotations=[],
                                   categories=[dict(id=1, name="a")])))
    return str(ann)


def test_load_image_matches_jax(tmp_path, monkeypatch):
    """`CocoDataset.load_image` of the port equals the JAX package's (cv2)
    on a JPEG mini-COCO, with and without cv2 importable."""
    ann = _jpeg_coco(tmp_path)
    jds = jcoco.CocoDataset(ann, str(tmp_path), test_mode=True)
    want = [jds.load_image(r) for r in jds.records]
    pds = pcoco.CocoDataset(ann, str(tmp_path), test_mode=True)
    for rec, ref in zip(pds.records, want):
        np.testing.assert_array_equal(pds.load_image(rec), ref)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for rec, ref in zip(pds.records, want):
        np.testing.assert_array_equal(pds.load_image(rec), ref)


def test_fixture_manifest():
    """tests/data/jpeg/manifest.json holds cv2.imread's shape and pixels'
    SHA-256 for every fixture, and the port decodes each to them."""
    manifest = json.loads((F.ROOT / "manifest.json").read_text())
    assert sorted(manifest) == sorted(p.name for p in F.ROOT.glob("*.jpg"))
    for name, want in manifest.items():
        path = str(F.ROOT / name)
        if "raises" in want:
            with pytest.raises(ValueError, match="progressive"):
                read_jpeg(path)
            continue
        ref = cv2.imread(path, cv2.IMREAD_COLOR)
        assert [list(ref.shape), sha256(ref)] == [want["shape"], want["sha256"]], name
        assert sha256(read_jpeg(path)) == want["sha256"], name


def test_corruption_manifest():
    """tests/data/jpeg/corruptions.json holds the SHA-256 of the JAX
    package's `corrupt` for every ported corruption at severities 1-5 on
    the two probe images, and the port reproduces every one."""
    ref = json.loads((F.ROOT / "corruptions.json").read_text())
    assert ref["seed"] == F.CORRUPTION_SEED and ref["probes"] == [list(p) for p in F.PROBES]
    assert sorted(ref["sha256"]) == sorted(pcorr.PORTED_CORRUPTIONS)
    probes = [probe_image(*p) for p in F.PROBES]
    for name, by_sev in ref["sha256"].items():
        for sev, hashes in by_sev.items():
            for img, h in zip(probes, hashes):
                assert sha256(jcorr.corrupt(img, name, int(sev), seed=ref["seed"])) == h
                assert sha256(pcorr.corrupt(img, name, int(sev), seed=ref["seed"])) == h


def test_host_build_needs_a_compiler(monkeypatch):
    """No fallback: without a C++ compiler the host build raises, naming
    the variable and the compiler."""
    monkeypatch.setenv("CXX", "/nonexistent/c++")
    with pytest.raises(RuntimeError, match="/nonexistent/c\\+\\+.*CXX"):
        _build.build_host()
    monkeypatch.delenv("CXX")
    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(RuntimeError, match="CXX.*c\\+\\+"):
        _build.build_host()
