"""Runnable examples of the torch port (counterparts of the repo's
examples/ scripts): `python -m partsbaseddetector_tpu_torch.examples.
rgbd_serving_demo` and `... .training_demo`. Both run on the card unless
given `--device cpu`."""
