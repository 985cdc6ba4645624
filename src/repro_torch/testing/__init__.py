"""Test support: synthetic ground-truth devices (:mod:`.synthdev`) and
the plain variants that show a kernel check can fail (:mod:`.variants`)."""
