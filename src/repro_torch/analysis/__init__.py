"""Static costing of the hand kernels and the built-in prediction
targets."""
