"""Launchers: serving a language model from ``repro_torch.models``."""
