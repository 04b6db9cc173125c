"""gauss_tpu_torch.tune — the tuner's seeds and its read side.

- :mod:`.space` — the declared tunable space per operation, with the hand
  constants as seed defaults;
- :mod:`.store` — the versioned JSON store of tuned configs, keyed by the
  port's hardware fingerprint (the JAX package's schema, the port's own
  file);
- :mod:`.apply` — the consult path ``core.blocked`` and ``core.lowered``
  read: the seeds when no store exists.

The sweep (the JAX package's ``tune/runner.py``) and ``compilecache`` are
not ported yet. Importing this package loads no torch.
"""

from gauss_tpu_torch.tune.store import TuneStore, TuneStoreError  # noqa: F401

__all__ = ["TuneStore", "TuneStoreError"]
