"""Hand-written Hopper kernels (``csrc/*.cu``), their plain PyTorch
versions (:mod:`.ref`) and the public wrappers (:mod:`.ops`)."""
