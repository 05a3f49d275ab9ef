"""Detection drawing and image writing without OpenCV.

`draw_detections` is `htd_tpu.utils.visualize.draw_detections` with its
three OpenCV calls replaced by copies that give the same pixels and bytes:
`rectangle` (`cv2.rectangle` at `LINE_8`, shift 0), `text.put_text`
(`cv2.putText` of OpenCV 5, which renders its embedded TrueType font) and
`imwrite` (`cv2.imwrite` for `.jpg` / `.jpeg` / `.jpe`, whose bytes are
libjpeg-turbo's at quality 95, and `.png`, whose pixels are the image's).
The reference is the OpenCV the tests run against, 5.0.0: OpenCV 4 draws
Hershey strokes for the same `putText` call.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from htd_tpu_torch.data.jpeg import write_jpeg
from htd_tpu_torch.data.png import write_png
from htd_tpu_torch.utils.text import put_text

JPEG_EXTENSIONS = (".jpg", ".jpeg", ".jpe")


def imwrite(path, img: np.ndarray) -> None:
    """Write `img` ((H, W, 3) uint8 BGR) to `path` as
    `cv2.imwrite` does for the extensions the JAX package's callers use:
    JPEG at quality 95 (`data.jpeg.write_jpeg`, cv2's bytes) or PNG
    (`data.png.write_png`, cv2's pixels). Other extensions raise."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext in JPEG_EXTENSIONS:
        write_jpeg(path, img)
    elif ext == ".png":
        write_png(path, img)
    else:
        raise ValueError(f"imwrite writes .jpg, .jpeg, .jpe and .png files, not {ext!r} "
                         f"({path})")


def _paint(img: np.ndarray, y0: int, y1: int, x0: int, x1: int, color) -> None:
    """Set rows y0..y1 and columns x0..x1 (inclusive) of `img`, clipped."""
    h, w = img.shape[:2]
    y0, x0 = max(y0, 0), max(x0, 0)
    y1, x1 = min(y1, h - 1), min(x1, w - 1)
    if y0 <= y1 and x0 <= x1:
        img[y0:y1 + 1, x0:x1 + 1] = color


def rectangle(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """Draw the outline of the box with corners `pt1` and `pt2` (integer
    pixels, in either order, inside or outside the image) into `img` in
    place, as `cv2.rectangle(img, pt1, pt2, color, thickness)` does with
    `LINE_8` and shift 0; return `img`. Thickness 1 is OpenCV's four
    one-pixel lines; thickness 2 is its thick polyline: each side a band
    three pixels wide (the side's line and one pixel either side of it,
    along the side's whole length) and each corner a filled circle of
    radius 1 (the corner and its four neighbours)."""
    if thickness not in (1, 2):
        raise ValueError(f"rectangle draws thickness 1 or 2, not {thickness}")
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError("rectangle draws into a uint8 (H, W) or (H, W, C) image")
    vals = [color] if np.isscalar(color) else list(color)
    c = 1 if img.ndim == 2 else img.shape[2]
    color = np.asarray((vals + [0] * c)[:c], np.uint8)
    if img.ndim == 2:
        color = color[0]
    x1, y1 = (int(v) for v in pt1)
    x2, y2 = (int(v) for v in pt2)
    xl, xr, yt, yb = min(x1, x2), max(x1, x2), min(y1, y2), max(y1, y2)
    r = thickness - 1
    for y in (y1, y2):                       # the horizontal sides
        _paint(img, y - r, y + r, xl, xr, color)
    for x in (x1, x2):                       # the vertical sides
        _paint(img, yt, yb, x - r, x + r, color)
    if r:
        for x, y in ((x1, y1), (x2, y1), (x2, y2), (x1, y2)):    # round caps
            _paint(img, y, y, x - 1, x + 1, color)
            _paint(img, y - 1, y + 1, x, x, color)
    return img


def draw_detections(
    img_bgr: np.ndarray,
    boxes: np.ndarray,
    scores: np.ndarray,
    labels: np.ndarray,
    class_names: Optional[Sequence[str]] = None,
    score_thr: float = 0.3,
    out_file: Optional[str] = None,
) -> np.ndarray:
    """A copy of `img_bgr` with each detection of score >= `score_thr`
    drawn: its box (2 pixels, the label's seeded colour) and its label
    "<name> <score:.2f>" above it; written to `out_file` when given. As
    `htd_tpu.utils.visualize.draw_detections`, pixel for pixel."""
    img = img_bgr.copy()
    keep = scores >= score_thr
    for box, score, label in zip(boxes[keep], scores[keep], labels[keep]):
        x1, y1, x2, y2 = [int(round(v)) for v in box]
        color = tuple(int(c) for c in np.random.RandomState(int(label)).randint(60, 255, 3))
        rectangle(img, (x1, y1), (x2, y2), color, 2)
        name = class_names[int(label)] if class_names else str(int(label))
        put_text(img, f"{name} {score:.2f}", (x1, max(y1 - 4, 10)), 0.5, color, 1)
    if out_file:
        imwrite(out_file, img)
    return img
