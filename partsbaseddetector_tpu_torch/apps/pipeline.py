"""Config-driven pipeline assembly (the ORK/ecto surface).

The reference exposes the detector as an `object_recognition_core`
pipeline configured by .by_parts YAML files (conf/config_face.by_parts:
sources -> pipeline(PartsBasedDetector, model_file, visualize,
max_overlap, remove_planes) -> sinks) wired through ecto cells
(cells/detect.cpp:115-154) and a Python blackbox
(python/object_recognition_by_parts/detector.py). This module keeps the
same declarative shape without ROS/ecto: a YAML config declares sources,
one PartsBasedDetector pipeline with parameters, and sinks; build()
returns a ready DetectionStream with sinks subscribed.

Config schema (a superset of the reference's fields we can honor):

    pipeline1:
      type: PartsBasedDetector
      parameters:
        model_file: path/to/model.{npz,xml,yml,mat}
        visualize: true            # subscribe an image sink
        max_overlap: 0.1           # paint-NMS threshold
        remove_planes: false
        conv_engine: spatial       # or fourier
        max_detections: 256
        camera: {fx: 525, fy: 525, cx: 319.5, cy: 239.5}

A copy of `partsbaseddetector_tpu/apps/pipeline.py` over the port's
detector. PyYAML is imported only by `parse_config` (and so
`build_from_file`): `build(PipelineConfig(...))` works without it.
`build` takes the device the detector runs on (default "cuda") and
passes any further keyword to PartsBasedDetector (buckets_per_octave=,
dtype=, ...).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from ..depth import StereoCameraModel
from ..detector import PartsBasedDetector
from ..models import load_model
from .stream import DetectionStream


@dataclasses.dataclass
class PipelineConfig:
    model_file: str
    visualize: bool = False
    max_overlap: float = 0.1
    remove_planes: bool = False
    conv_engine: str = "spatial"
    max_detections: int = 256
    camera: Optional[dict] = None
    name: str = "pipeline1"
    raw: Optional[dict] = None


def parse_config(path_or_text: str) -> PipelineConfig:
    """Parse a .by_parts-style YAML config; the first pipeline entry of
    type PartsBasedDetector wins. Needs PyYAML."""
    import yaml

    if "\n" not in path_or_text and os.path.exists(path_or_text):
        with open(path_or_text) as fh:
            doc = yaml.safe_load(fh)
    else:
        doc = yaml.safe_load(path_or_text)
    if not isinstance(doc, dict):
        raise ValueError("config must be a YAML mapping")
    for key, section in doc.items():
        if not isinstance(section, dict):
            continue
        if section.get("type") != "PartsBasedDetector":
            continue
        params = section.get("parameters", {}) or {}
        extra = params.get("extra", {}) or {}
        model_file = params.get("model_file") or extra.get("model_file")
        if not model_file:
            raise ValueError(f"{key}: missing model_file")
        return PipelineConfig(
            model_file=model_file,
            visualize=bool(params.get("visualize", False)),
            max_overlap=float(params.get("max_overlap", 0.1)),
            remove_planes=bool(params.get("remove_planes", False)),
            conv_engine=str(params.get("conv_engine", "spatial")),
            max_detections=int(params.get("max_detections", 256)),
            camera=params.get("camera"),
            name=key,
            raw=doc,
        )
    raise ValueError("no PartsBasedDetector pipeline in config")


def build(config: PipelineConfig, device="cuda", **detector_kw) -> DetectionStream:
    """Instantiate the detector + stream from a parsed config; the
    detector runs on `device`, with `detector_kw` as further options."""
    model = load_model(config.model_file)
    detector = PartsBasedDetector(
        model,
        max_detections=config.max_detections,
        conv_engine=config.conv_engine,
        device=device,
        **detector_kw,
    )
    camera = None
    if config.camera:
        camera = StereoCameraModel(**config.camera)
    stream = DetectionStream(
        detector,
        camera=camera,
        max_overlap=config.max_overlap,
        remove_planes_first=config.remove_planes,
    )
    if config.visualize:
        stream.subscribe("image", lambda im: None)
    return stream


def build_from_file(path: str, device="cuda", **detector_kw) -> DetectionStream:
    return build(parse_config(path), device=device, **detector_kw)
