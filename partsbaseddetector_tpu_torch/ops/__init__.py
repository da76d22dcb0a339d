"""Compute ops of the torch port: pyramid resampling, HOG, part-filter
responses (K2), distance transforms (K1/K3) and the tree DP.

The JAX package's `ops` re-exports, on the port's ops. Importing this
package builds and loads no kernel: that happens at the first launch
on a CUDA tensor."""

from . import reference  # NumPy semantic spec / golden implementation
from .conv import filter_responses, filter_responses_fft
from .distance_transform import distance_transform_2d, shift_distance_transform_2d
from .hog import hog_features
from .resize import reduce_image, reduce_matrix, resize_image, resize_matrix
