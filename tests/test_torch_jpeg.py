"""The port's JPEG decoder (`htd_tpu_torch.data.jpeg`, C++ built for the
host) against OpenCV's `imdecode` / `imread(IMREAD_COLOR)`, bit for bit, on
seeded images that OpenCV and PIL encode here: every sampling OpenCV
writes, qualities 5-100, odd sizes down to 1x1, restart intervals, PIL's
optimised tables, grey, EXIF orientations 1-8 in both byte orders, files
of one scan per component written here, progressive files (OpenCV's and
PIL's), PIL's CMYK files, and baseline and progressive files cut short
(`imread` of the file: libjpeg's inserted EOI, zero bits, block smoothing);
arithmetic-coded and lossless files written here (`tests/jpeg_fixtures.py`'s
coders), cut short too; the files it refuses, where imread returns None;
`CocoDataset.load_image` against the JAX package's; the two manifests of
`tests/data/jpeg/` against cv2 and the JAX package."""

import json
import re
import sys

import cv2
import numpy as np
import pytest
import torch

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


def _assert_reads_as_imread(path) -> None:
    """read_jpeg(path) is cv2.imread(path)'s image, or raises ValueError
    naming the file where imread returns nothing."""
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if want is None:
        with pytest.raises(ValueError, match=re.escape(path.name)):
            read_jpeg(path)
    else:
        np.testing.assert_array_equal(read_jpeg(path), want, err_msg=path.name)


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("sampling", [444, 422, 420, 440, 411])
def test_progressive_cv2(sampling, restart, tmp_path):
    """OpenCV's progressive files (its libjpeg's standard scan script: DC
    first and refinement, AC first with EOB runs and AC refinement) at every
    sampling, qualities 5-100, odd sizes down to 1x1, with and without a
    restart interval, read as imread reads them."""
    path = tmp_path / "p.jpg"
    for i, (h, w) in enumerate(SIZES):
        for q in (5, 50, 100):
            path.write_bytes(F.cv2_jpeg(F.pattern(i, h, w), q, sampling, restart, progressive=True))
            _assert_reads_as_imread(path)


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_progressive_pil(subsampling, optimize, tmp_path):
    """PIL's progressive files at 4:4:4, 4:2:2 and 4:2:0, with its default
    and its optimised Huffman tables; grey ones; one with EXIF orientation 6."""
    path = tmp_path / "p.jpg"
    for i, (h, w) in enumerate(SIZES):
        img = F.pattern(i, h, w)
        for q in (7, 40, 95):
            path.write_bytes(F.pil_jpeg(img, quality=q, subsampling=subsampling,
                                        optimize=optimize, progressive=True))
            _assert_reads_as_imread(path)
        path.write_bytes(F.pil_jpeg(img[..., subsampling], quality=60, optimize=optimize,
                                    progressive=True))
        _assert_reads_as_imread(path)
    path.write_bytes(F.with_exif(F.pil_jpeg(F.pattern(9, 20, 36), quality=80, optimize=optimize,
                                            subsampling=subsampling, progressive=True), 6))
    assert read_jpeg(path).shape == (36, 20, 3)
    _assert_reads_as_imread(path)


@pytest.mark.parametrize("progressive", [False, True])
def test_cmyk(progressive, tmp_path):
    """PIL's CMYK files (Adobe transform 0) at two sizes and qualities:
    libjpeg's CMYK output turned into BGR as OpenCV does (each of C, M, Y as
    K - ((255 - x) K >> 8))."""
    path = tmp_path / "c.jpg"
    for i, (h, w) in enumerate([(16, 24), (37, 50)]):
        for q in (30, 95):
            path.write_bytes(F.cmyk_jpeg(F.pattern(20 + i, h, w), q, progressive=progressive))
            _assert_reads_as_imread(path)


@pytest.mark.parametrize("subsampled", [False, True])
def test_ycck(subsampled, tmp_path):
    """YCCK files (Adobe transform 2) written here from CMYK through
    jccolor.c's cmyk_ycck_convert, which no library here writes: the port
    turns them back as jdcolor.c's ycck_cmyk_convert does and then as CMYK,
    equal to imread, at odd sizes down to 1x1 and several qualities."""
    path = tmp_path / "y.jpg"
    for i, ((h, w), q) in enumerate([((27, 41), 85), ((16, 24), 30), ((9, 17), 95),
                                     ((1, 1), 60)]):
        img, k = F.pattern(60 + i, h, w), F.pattern(70 + i, h, w)[..., 2]
        path.write_bytes(F.ycck_jpeg(img, k, q, subsampled))
        assert cv2.imread(str(path), cv2.IMREAD_COLOR) is not None
        _assert_reads_as_imread(path)


@pytest.mark.parametrize("kind", ["baseline", "restart", "progressive", "progressive-restart"])
def test_truncated(kind, tmp_path):
    """Files cut short at offsets across their headers and every scan read
    as imread reads them: the rest of the cut MCU from zero bits, later MCUs
    left as they were, libjpeg's block smoothing where a progressive file's
    coefficients are not fully known, ValueError naming the file where
    imread returns nothing (a cut before the first scan's data)."""
    img = F.pattern(30, 40, 56)
    data = F.cv2_jpeg(img, 90, 420, restart=2 if "restart" in kind else 0,
                      progressive=kind.startswith("progressive"))
    scans = F.scans(data)
    cuts = {2, 100, scans[0][0] - 3, scans[0][0]}
    for start, end in scans:
        cuts.update(range(start + 1, end, max(1, (end - start) // 4)))
    for cut in sorted(cuts):
        path = tmp_path / f"{kind}_{cut}.jpg"
        path.write_bytes(data[:cut])
        _assert_reads_as_imread(path)


def test_refuses_what_it_cannot_read(tmp_path):
    """Files that end before their first scan's data and files that are not
    JPEG raise ValueError naming the file (imread returns nothing for
    them)."""
    data = F.cv2_jpeg(F.pattern(1, 40, 56), 90)
    for cut in (100, data.index(b"\xff\xda") + 5):
        path = tmp_path / f"cut{cut}.jpg"
        path.write_bytes(data[:cut])
        assert cv2.imread(str(path), cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match=rf"cut{cut}\.jpg: "):
            read_jpeg(path)
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG\r\n\x1a\n")


@pytest.mark.parametrize("case,message", [
    ("SOF5", "hierarchical"), ("12-bit", "only 8-bit"), ("2 components", "not 2 components"),
    ("65535x65535", "2\\*\\*30")])
def test_refuses_other_kinds(case, message):
    """Each kind of file the decoder does not read has its own message:
    baseline files whose frame header says otherwise (hierarchical, 12-bit,
    2 components), a frame over OpenCV's 2**30-pixel limit (which cv2
    refuses too)."""
    data = bytearray(F.cv2_jpeg(F.pattern(0, 16, 24), 80))
    sof = data.index(b"\xff\xc0")
    if case.startswith("SOF"):
        data[sof + 1] = 0xC0 + int(case[3:])
    elif case == "12-bit":
        data[sof + 4] = 12
    elif case == "2 components":
        data[sof + 9] = 2
    else:
        data[sof + 5:sof + 9] = b"\xff\xff\xff\xff"
        assert _cv2(bytes(data)) is None
    with pytest.raises(ValueError, match=message):
        decode_jpeg(bytes(data))


DAC_OPTIONS = [{}, {"restart": 2}, {"dac": F.DAC}, {"restart": 1, "dac": F.DAC}]


@pytest.mark.parametrize("options", DAC_OPTIONS, ids=["plain", "restart", "dac", "both"])
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "grey"])
def test_arithmetic(sampling, progressive, options):
    """Arithmetic-coded files (SOF9, SOF10 with libjpeg's standard scan
    script) at every sampling and grey, odd sizes down to 1x1, with a
    restart interval and non-default DAC conditioning, decode bit-equal to
    cv2; and the test-side coder is right: imread of each file equals
    imread of its Huffman twin of the same coefficients."""
    for i, (h, w) in enumerate(SIZES):
        img = F.pattern(60 + i, h, w)
        frame = F.coefficients(img[..., 0] if sampling == "grey" else img, 40 + 10 * i,
                               "420" if sampling == "grey" else sampling)
        data = F.arithmetic_jpeg(frame, progressive, **options)
        _assert_decodes_as_cv2(data)
        np.testing.assert_array_equal(_cv2(data), _cv2(F.huffman_twin(frame)))


@pytest.mark.parametrize("progressive", [False, True])
def test_arithmetic_cut(progressive, tmp_path):
    """Arithmetic files cut short across their scans (and restart
    intervals) read as imread reads them: after libjpeg's inserted EOI the
    decoder reads zero bytes and decodes every later MCU from them; block
    smoothing where a progressive file's coefficients are not fully known."""
    data = F.arithmetic_jpeg(F.coefficients(F.pattern(70, 40, 56), 85, "420"), progressive,
                             restart=0 if progressive else 4)
    cuts = set()
    for start, end in F.scans(data):
        cuts.update(range(start + 1, end, max(1, (end - start) // 5)))
    for cut in sorted(cuts):
        path = tmp_path / f"a{cut}.jpg"
        path.write_bytes(data[:cut])
        _assert_reads_as_imread(path)


JFIF = F._segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("pt", [0, 2])
@pytest.mark.parametrize("color", ["rgb", "rgb-no-marker", "cmyk", "rgb-420", "grey", "ycc"])
def test_lossless(color, pt, restart, tmp_path):
    """Lossless files (SOF3) at predictors 1-7, point transforms 0 and 2,
    with and without a restart interval, read as imread reads them: RGB
    (Adobe transform 0, or no marker), CMYK and subsampled RGB as the file's
    samples (x << Pt; upsampled by replication), grey and YCbCr refused as
    imread refuses them (libjpeg-turbo converts no colour space for lossless
    data). With Pt 0, RGB reads as the source pixels."""
    path = tmp_path / "l.jpg"
    for i, (h, w) in enumerate(SIZES):
        img = F.pattern(80 + i, h, w)
        planes = F.lossless_planes(img, color.split("-")[0] if color != "cmyk" else "rgb")
        kwargs = {"app": JFIF if color == "ycc" else b"" if color in ("grey", "rgb-no-marker")
                  else F.ADOBE_RGB}
        if color == "cmyk":
            planes.append(img[..., 1] // 2 + 60)
        elif color == "rgb-420":
            planes = [np.repeat(np.repeat(planes[0], 2, 0), 2, 1), planes[1], planes[2]]
            kwargs["hv"] = [(2, 2), (1, 1), (1, 1)]
        for predictor in range(1, 8):
            path.write_bytes(F.lossless_jpeg(planes, predictor, pt, restart, **kwargs))
            _assert_reads_as_imread(path)
            if color.startswith("rgb") and color != "rgb-420" and pt == 0:
                np.testing.assert_array_equal(read_jpeg(path), img)
    if color in ("grey", "ycc"):
        with pytest.raises(ValueError, match="colour conversion"):
            read_jpeg(path)


def test_lossless_precision(tmp_path):
    """RGB lossless files of 2- to 16-bit precision: imread reads 2-8 bits
    (the samples as they are, no scaling to 8 bits) and refuses 9-16, as
    the port does."""
    planes = F.lossless_planes(F.pattern(90, 17, 33), "rgb")
    for bits in range(2, 17):
        path = tmp_path / f"p{bits}.jpg"
        x = [(p.astype(np.int64) >> max(0, 8 - bits)) << max(0, bits - 8) for p in planes]
        path.write_bytes(F.lossless_jpeg(x, 6, 1, precision=bits, app=F.ADOBE_RGB))
        _assert_reads_as_imread(path)
        if bits > 8:
            with pytest.raises(ValueError, match="only 8-bit DCT and 2- to 8-bit lossless"):
                read_jpeg(path)


@pytest.mark.parametrize("case,message", [
    ("12-bit", "only 8-bit"), ("SOF5", "hierarchical"), ("SOF6", "hierarchical"),
    ("SOF7", "hierarchical"), ("SOF13", "hierarchical"), ("SOF14", "hierarchical"),
    ("SOF15", "hierarchical"), ("SOF11", "lossless arithmetic"),
    ("lossless restart", "corrupt"), ("lossless Pt >= P", "corrupt")])
def test_refused_as_imread_refuses(case, message, tmp_path):
    """The kinds imread returns None for raise ValueError naming the file
    and the reason: 12-bit DCT files (OpenCV reads through libjpeg's 8-bit
    interface), hierarchical files (no libjpeg decodes them), lossless
    arithmetic files (libjpeg-turbo has no decoder for them), a lossless
    restart interval that is not a whole number of MCU rows, a point
    transform as large as the precision."""
    if case.startswith("lossless") or case == "SOF11":
        data = bytearray(F.lossless_jpeg(F.lossless_planes(F.pattern(1, 16, 24), "rgb"), 1,
                                         restart_rows=2 * (case == "lossless restart"),
                                         app=F.ADOBE_RGB))
        if case == "SOF11":
            data[data.index(b"\xff\xc3") + 1] = 0xCB
        elif case == "lossless restart":
            data[data.index(b"\xff\xdd") + 5] += 1
        else:
            sos = data.index(b"\xff\xda")
            data[sos + 13] = 8      # marker, length, Ns, 3 x (id, tables), Ss, Se, then Ah Al
    else:
        data = bytearray(F.cv2_jpeg(F.pattern(0, 16, 24), 80))
        sof = data.index(b"\xff\xc0")
        if case == "12-bit":
            data[sof + 1], data[sof + 4] = 0xC1, 12
        else:
            data[sof + 1] = 0xC0 + int(case[3:])
    path = tmp_path / "r.jpg"
    path.write_bytes(bytes(data))
    assert cv2.imread(str(path), cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match=f"r\\.jpg: .*{message}"):
        read_jpeg(path)


@pytest.mark.parametrize("kind", ["arithmetic", "progressive arithmetic", "lossless"])
def test_exif_on_new_kinds(kind, tmp_path):
    """EXIF orientation 6 applies to arithmetic-coded and lossless files as
    to the others (a transpose, then a horizontal flip)."""
    img = F.pattern(95, 20, 36)
    data = (F.lossless_jpeg(F.lossless_planes(img, "rgb"), 4, app=F.ADOBE_RGB)
            if kind == "lossless" else
            F.arithmetic_jpeg(F.coefficients(img, 80, "420"), kind.startswith("progressive")))
    path = tmp_path / "o.jpg"
    path.write_bytes(F.with_exif(data, 6))
    assert read_jpeg(path).shape == (36, 20, 3)
    _assert_reads_as_imread(path)


@pytest.mark.parametrize("code", [0xC3, 0xC9, 0xCA])
def test_patched_frame_reads_as_imread(code, tmp_path):
    """A baseline Huffman file whose frame header is patched to lossless
    (SOF3: its scan parameters are then invalid) or to arithmetic coding
    (SOF9, SOF10: its Huffman data decoded as arithmetic-coded garbage)
    reads as imread reads it."""
    data = bytearray(F.cv2_jpeg(F.pattern(0, 16, 24), 80))
    data[data.index(b"\xff\xc0") + 1] = code
    path = tmp_path / "p.jpg"
    path.write_bytes(bytes(data))
    _assert_reads_as_imread(path)


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
        ref = cv2.imread(path, cv2.IMREAD_COLOR)
        assert [list(ref.shape), sha256(ref)] == [want["shape"], want["sha256"]], name
        assert sha256(read_jpeg(path)) == want["sha256"], name


def test_corruption_manifest():
    """tests/data/jpeg/corruptions.json holds the SHA-256 of the JAX
    package's `corrupt` for all 19 corruptions at severities 1-5 on the two
    probe images, and the port reproduces every one."""
    ref = json.loads((F.ROOT / "corruptions.json").read_text())
    assert ref["seed"] == F.CORRUPTION_SEED and ref["probes"] == [list(p) for p in F.PROBES]
    assert sorted(ref["sha256"]) == sorted(pcorr.ALL_CORRUPTIONS)
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
