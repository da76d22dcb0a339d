"""Application surfaces: demo CLI, model transfer CLI, config-driven
pipelines, streaming node, serializable messages.

Copies of `partsbaseddetector_tpu/apps/`, so that the port never imports
the JAX package; the entry points that run a detector default to
device="cuda"."""
