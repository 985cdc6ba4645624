"""Test support: synthetic ground-truth devices (:mod:`.synthdev`)."""
