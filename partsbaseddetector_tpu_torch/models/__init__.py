"""Model layer: canonical part-model container, packed form, its torch
device copy, the npz serialization, the OpenCV FileStorage (XML/YAML)
and MATLAB (.mat) readers and writers, conversion from the JAX
package's models and their trainable pools, and synthetic model
generators."""

from .model import (
    DeviceComponent,
    DeviceModel,
    Model,
    ModelSpec,
    PackedComponent,
    PackedModel,
    load_model,
    make_face_like_model,
    make_person_like_model,
    make_synthetic_model,
    pack_model,
    save_model,
    to_device,
)
from .convert import (
    model_from_arrays,
    model_from_jax,
    params_from_jax,
    params_to_numpy,
)
from .filestorage import FileStorageModel
from .matlabio import MatlabIOModel
