"""The port's examples (partsbaseddetector_tpu_torch/examples/) on the
CPU: the RGB-D serving demo prints what the JAX package's
examples/rgbd_serving_demo.py prints (candidates, poses and messages per
frame), and the training demo trains its three-part model and finds the
held-out pattern (PCK@0.5 of 1.0 for every part measured; at least 0.5
asked)."""

import importlib.util
import os

import numpy as np

from partsbaseddetector_tpu_torch.examples import rgbd_serving_demo, training_demo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rgbd_demo_prints_the_jax_demos_lines(capsys):
    frames = rgbd_serving_demo.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    _jax_example("rgbd_serving_demo").main()
    want = capsys.readouterr().out.splitlines()
    assert len(frames) == 3 and sum(len(f.candidates) for f in frames) > 0
    assert got == want


def test_training_demo_trains_on_the_cpu(capsys):
    model, pck = training_demo.main(["--fast", "--device", "cpu"])
    model.validate()
    assert len(pck) == 3 and np.min(pck) >= 0.5
    assert "held-out PCK@0.5" in capsys.readouterr().out
