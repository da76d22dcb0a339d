"""Annotation and dataset preparation utilities.

Re-expression of matlab/learning/{annotateParts.m, getPositiveData.m,
getNegativeData.m, map_rotate_points.m}: a directory-scanning dataset
builder with train/test splitting, rotation augmentation for keypoints,
and a part annotator. The reference's annotator is a MATLAB ginput loop;
here annotation is programmatic by default with an optional matplotlib
click UI for interactive use.

A NumPy copy of `partsbaseddetector_tpu/train/annotate.py`,
kept verbatim so that the port never imports the JAX package.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def get_positive_data(
    image_dir: str,
    annotation_file: str,
    pattern: str = r".*\.(png|jpg|jpeg|bmp)$",
    split: float = 0.5,
    seed: int = 0,
) -> Tuple[List[Dict], List[Dict]]:
    """Scan a directory for annotated positives and split train/test
    (getPositiveData.m). The annotation file is JSON:
    {filename: [[x, y], ...]} keypoints per image."""
    with open(annotation_file) as fh:
        ann = json.load(fh)
    rx = re.compile(pattern, re.IGNORECASE)
    examples = []
    for name in sorted(os.listdir(image_dir)):
        if not rx.match(name) or name not in ann:
            continue
        examples.append(
            {
                "im": os.path.join(image_dir, name),
                "points": np.asarray(ann[name], dtype=np.float64),
            }
        )
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(examples))
    ntrain = int(round(len(examples) * split))
    train = [examples[i] for i in order[:ntrain]]
    test = [examples[i] for i in order[ntrain:]]
    return train, test


def get_negative_data(
    image_dir: str,
    pattern: str = r".*\.(png|jpg|jpeg|bmp)$",
    limit: Optional[int] = None,
) -> List[Dict]:
    """Scan a directory of background images (getNegativeData.m)."""
    rx = re.compile(pattern, re.IGNORECASE)
    out = []
    for name in sorted(os.listdir(image_dir)):
        if rx.match(name):
            out.append({"im": os.path.join(image_dir, name)})
            if limit and len(out) >= limit:
                break
    return out


def map_rotate_points(
    points: np.ndarray, im_shape: Tuple[int, int], angle_deg: float
) -> np.ndarray:
    """Rotate keypoints about the image center (map_rotate_points.m);
    used for rotation augmentation of annotations."""
    h, w = im_shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    t = np.deg2rad(angle_deg)
    c, s = np.cos(t), np.sin(t)
    x = points[:, 0] - cx
    y = points[:, 1] - cy
    return np.stack([c * x - s * y + cx, s * x + c * y + cy], axis=1)


def save_annotations(path: str, annotations: Dict[str, np.ndarray]) -> None:
    with open(path, "w") as fh:
        json.dump({k: np.asarray(v).tolist() for k, v in annotations.items()}, fh)


def load_annotations(path: str) -> Dict[str, np.ndarray]:
    with open(path) as fh:
        return {
            k: np.asarray(v, dtype=np.float64) for k, v in json.load(fh).items()
        }


def annotate_parts_interactive(
    image_paths: Sequence[str], nparts: int, out_file: str
) -> Dict[str, np.ndarray]:  # pragma: no cover - interactive
    """Click-based part annotator (annotateParts.m analog). Requires a
    display; click nparts points per image, close the figure to advance."""
    import matplotlib.pyplot as plt
    from PIL import Image

    annotations: Dict[str, np.ndarray] = {}
    for path in image_paths:
        im = np.asarray(Image.open(path).convert("RGB"))
        fig, ax = plt.subplots()
        ax.imshow(im)
        ax.set_title(f"click {nparts} part locations: {os.path.basename(path)}")
        pts = plt.ginput(nparts, timeout=0)
        plt.close(fig)
        annotations[os.path.basename(path)] = np.asarray(pts, dtype=np.float64)
        save_annotations(out_file, annotations)
    return annotations
