"""Compute ops of the torch port: pyramid resampling, HOG, part-filter
responses (K2), distance transforms (K1/K3) and the tree DP."""
