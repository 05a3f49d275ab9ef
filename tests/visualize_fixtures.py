"""The detections and the manifest of `tests/data/visualize/`.

    python -m tests.visualize_fixtures   # rewrites them (needs cv2 and the JAX package)

`detections.json` holds 50 seeded detections on `tests/data/jpeg/photo0.jpg`
(boxes as float32 values, some across or on the image's edges and some on
half pixels, scores on both sides of 0.3, labels over COCO's 80 classes) and
COCO's 80 class names. `manifest.json` holds what the reference gives here:

- "encode": for every fixture of `tests/data/jpeg/` but the photo-sized
  progressive and arithmetic ones, the SHA-256 of the bytes of
  `cv2.imencode(".jpg", cv2.imread(fixture))` and of the pixels
  `cv2.imdecode` reads back from them;
- "draw": the SHA-256 of the pixels `htd_tpu.utils.visualize.draw_detections`
  returns for the detections on photo0 (score_thr 0.3) and of the `.jpg`
  file it writes;
- "browse": for each run of `tools/browse_dataset.py` that `chip_smoke.py`
  (phase 28, `BROWSE_RUNS`) repeats with `tools_torch/browse_dataset.py` (on phase 26's
  JPEG mini-COCO: default, --raw and --corruption gaussian_noise --severity
  3; on phase 24's PNG mini-COCO: default), each written file's SHA-256:
  of its bytes for `.jpg`, of its pixels as `cv2.imread` reads them for
  `.png`.

The reference is OpenCV 5.0.0 (its `putText` renders an embedded TrueType
font; OpenCV 4 draws Hershey strokes instead).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path

import numpy as np

import chip_smoke
from chip_smoke import BROWSE_RUNS, browse_sets

ROOT = Path(__file__).resolve().parent / "data" / "visualize"
JPEG_ROOT = Path(__file__).resolve().parent / "data" / "jpeg"
DRAW_IMAGE = "photo0.jpg"
DRAW_SCORE_THR = 0.3
N_DETECTIONS = 50

COCO_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train", "truck", "boat",
    "traffic light", "fire hydrant", "stop sign", "parking meter", "bench", "bird", "cat", "dog",
    "horse", "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard", "tennis racket", "bottle",
    "wine glass", "cup", "fork", "knife", "spoon", "bowl", "banana", "apple", "sandwich",
    "orange", "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair", "couch",
    "potted plant", "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink", "refrigerator", "book",
    "clock", "vase", "scissors", "teddy bear", "hair drier", "toothbrush")


def sha256(data) -> str:
    """SHA-256 of bytes, or of an array's C-order bytes."""
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(data).hexdigest()


def encode_fixtures() -> list:
    """The `tests/data/jpeg` fixtures whose decoded pixels the encoder is
    held to: every one but the photo-sized progressive and arithmetic files."""
    names = json.loads((JPEG_ROOT / "manifest.json").read_text())
    return [n for n in names if not n.startswith(("photo4", "photo5"))]


def seeded_detections(h: int, w: int, seed: int = 14):
    """(boxes (N, 4) float32, scores (N,) float32, labels (N,) int64)."""
    rng = np.random.RandomState(seed)
    n = N_DETECTIONS
    x1, y1 = rng.uniform(-40, w - 10, n), rng.uniform(-40, h - 10, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(0, 260, n), y1 + rng.uniform(0, 200, n)], 1)
    boxes[:6] = [[0, 0, w - 1, h - 1], [-12.5, 3.5, 40.5, h + 20], [w - 30.5, h - 20.5, w + 5, h],
                 [w / 2, 0.5, w / 2, 0.5], [10.5, 11.5, 9.5, 60.5], [-1000, -1000, 2000, 2000]]
    boxes[6:12] = np.floor(boxes[6:12]) + 0.5            # half pixels: round half to even
    scores = rng.uniform(0.05, 1.0, n)
    scores[:6] = [0.99, 0.3, 0.2999, 1.0, 0.5, 0.75]
    labels = rng.randint(0, len(COCO_CLASSES), n)
    return boxes.astype(np.float32), scores.astype(np.float32), labels.astype(np.int64)


def load_detections():
    """(image name, boxes, scores, labels, class names) of detections.json."""
    return chip_smoke.load_detections(str(ROOT))


def _jax_browse(argv) -> None:
    import importlib.util
    import sys

    spec = importlib.util.spec_from_file_location(
        "jax_browse_dataset", Path(__file__).resolve().parent.parent / "tools" /
        "browse_dataset.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    saved = sys.argv
    sys.argv = ["browse_dataset.py", *argv]
    try:
        mod.main()
    finally:
        sys.argv = saved


def main() -> None:
    import cv2

    from htd_tpu.utils.visualize import draw_detections

    ROOT.mkdir(parents=True, exist_ok=True)
    photo = cv2.imread(str(JPEG_ROOT / DRAW_IMAGE))
    boxes, scores, labels = seeded_detections(*photo.shape[:2])
    (ROOT / "detections.json").write_text(json.dumps({
        "image": DRAW_IMAGE, "boxes": boxes.tolist(), "scores": scores.tolist(),
        "labels": labels.tolist(), "class_names": list(COCO_CLASSES)}, indent=1) + "\n")
    _, boxes, scores, labels, names = load_detections()
    manifest = {"encode": {}, "draw": {}, "browse": {}}
    for name in encode_fixtures():
        img = cv2.imread(str(JPEG_ROOT / name))
        data = cv2.imencode(".jpg", img)[1].tobytes()
        manifest["encode"][name] = {"shape": list(img.shape), "sha256": sha256(data),
                                    "decoded_sha256": sha256(cv2.imdecode(
                                        np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "drawn.jpg")
        drawn = draw_detections(photo, boxes, scores, labels, names, DRAW_SCORE_THR, out)
        manifest["draw"] = {"image": DRAW_IMAGE, "score_thr": DRAW_SCORE_THR,
                            "pixels_sha256": sha256(drawn),
                            "jpg_sha256": sha256(Path(out).read_bytes())}
        jm = json.loads((JPEG_ROOT / "manifest.json").read_text())
        photos = [(n, tuple(jm[n]["shape"][:2])) for n in sorted(jm) if n.startswith("photo")]
        sets = browse_sets(tmp, photos)
        for key, which, opts in BROWSE_RUNS:
            ann, img_root = sets[which]
            out_dir = os.path.join(tmp, key)
            _jax_browse(["--ann", ann, "--img-root", img_root, "--output-dir", out_dir, *opts])
            manifest["browse"][key] = {
                f: sha256(cv2.imread(os.path.join(out_dir, f)) if f.endswith(".png") else
                          Path(out_dir, f).read_bytes()) for f in sorted(os.listdir(out_dir))}
    (ROOT / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")


if __name__ == "__main__":
    main()
