"""Tuning seeds (:mod:`.space`); the tuner itself is not ported yet."""
