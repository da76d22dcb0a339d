"""partsbaseddetector_tpu_torch — the parts-based detector on PyTorch and
CUDA (NVIDIA Hopper).

A port of `partsbaseddetector_tpu` (JAX on a TPU), which stays the
reference it is tested against. This package imports torch and never
jax. Its main path is `PartsBasedDetector.detect` with the f32 profile
and the spatial engine: the part-filter responses and the distance
transforms run hand-written CUDA kernels (`csrc/`) on a CUDA device,
and their plain torch versions on the CPU. The Fourier engine, RGB-D
detection (`depth_gate`, `device_depth_filter`), the adaptive-window
distance transform (`PBD_DT_WINDOW=1`), the part NMS (`nms_overlap`),
the batch and stream serving APIs, the SGD and QP/latent trainers and
the surfaces are ported too: the model readers and writers (.npz,
OpenCV .xml/.yml, MATLAB .mat), evaluation (`eval`), visualization, the
point-cloud stages (`cloud`), the apps (demo, model transfer, the
config-driven pipeline and the streaming node with its messages),
profiling, and the host-only CPUPartsBasedDetector on the native C++
kernels. Every entry point that runs a detector on the card does so
unless it is given device="cpu".
"""

__version__ = "0.1.0"

from .cpu_detector import CPUPartsBasedDetector
from .detector import PartsBasedDetector
from .models import (
    Model,
    ModelSpec,
    load_model,
    make_face_like_model,
    make_person_like_model,
    make_synthetic_model,
    model_from_arrays,
    model_from_jax,
    save_model,
)
from .types import Candidate, DetectionResult
from .visualize import Visualize

__all__ = [
    "CPUPartsBasedDetector",
    "Candidate",
    "DetectionResult",
    "Model",
    "ModelSpec",
    "PartsBasedDetector",
    "Visualize",
    "load_model",
    "make_face_like_model",
    "make_person_like_model",
    "make_synthetic_model",
    "model_from_arrays",
    "model_from_jax",
    "save_model",
    "__version__",
]
