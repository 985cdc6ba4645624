"""Counting, model expressions, calibration and the UIPiCK battery."""
