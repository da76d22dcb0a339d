"""The torch port must never import jax, optax or orbax (its package,
training, the surfaces, parallel/, the examples and the bench entry
point included), nor need PyYAML
or PIL to import (the card's machine may lack them: only reading .yml
models, parse_config and the demo's image I/O use them, at call time),
nor build or load a kernel library when imported (`ops` included).

Runs in a subprocess: this test process has jax loaded (conftest.py
imports it). The subprocess drops any such module already loaded and
installs an import hook that refuses them, blocks yaml and PIL, then
imports every module of the port."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, sys

    BANNED = ("jax", "jaxlib", "optax", "orbax")
    for name in [m for m in sys.modules if m.split(".")[0] in BANNED]:
        del sys.modules[name]

    class NoJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BANNED:
                raise ImportError("the torch port imported " + name)
            return None

    sys.meta_path.insert(0, NoJax())
    for name in [m for m in sys.modules if m.split(".")[0] in ("yaml", "PIL")]:
        del sys.modules[name]
    sys.modules["yaml"] = sys.modules["PIL"] = None  # import raises
    import partsbaseddetector_tpu_torch as pkg

    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(info.name)

    for mod in ("train.sgd", "train.fit", "train.checkpoint", "pipeline",
                "ops.reference_pipeline", "train.detect_tpu", "train.latent",
                "train.qp", "train.trainmodel", "models.filestorage",
                "models.matlabio", "models.transfer", "eval.metrics",
                "visualize", "visualize_model", "cloud", "apps.sync",
                "apps.messages", "apps.stream", "apps.pipeline", "apps.demo",
                "apps.model_transfer", "utils.profiling", "cpu_detector",
                "native", "parallel", "parallel.mesh", "parallel.distributed",
                "examples.rgbd_serving_demo", "examples.training_demo", "bench"):
        assert pkg.__name__ + "." + mod in sys.modules, mod
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
    assert not loaded, loaded
    from partsbaseddetector_tpu_torch import kernels

    # nothing built or loaded: the kernels build at their first launch
    assert kernels._lib is None
    with open("/proc/self/maps") as maps:
        mapped = [ln for ln in maps if "torch_kernels" in ln or "libpbd_kernels" in ln]
    assert not mapped, mapped
    assert "partsbaseddetector_tpu" not in sys.modules
    assert pkg.CPUPartsBasedDetector and pkg.Visualize
    from partsbaseddetector_tpu_torch import parallel

    assert callable(parallel.make_mesh) and callable(parallel.distributed_train_step)
    from partsbaseddetector_tpu_torch.apps import pipeline

    pipeline.PipelineConfig(model_file="m.xml")  # build() needs no yaml
    try:
        pipeline.parse_config("a: 1")
    except ImportError:
        pass
    else:
        raise AssertionError("parse_config ran without yaml")
    print("ok")
    """
)


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
