"""Versioned on-disk store of tuned configs, keyed by hardware fingerprint
(the read side of the JAX package's ``tune/store.py``).

One JSON file holds the winning configs a sweep measured on one machine,
in the JAX package's schema::

    {"version": 1,
     "fingerprint": {"backend": "cuda", "device_kind": "NVIDIA H100 80GB HBM3",
                     "device_count": 1, "torch": "2.11.0+cu128"},
     "created_unix": 1754300000.0,
     "configs": {
        "lowered/n2048/float32/blocked": {
            "params": {"dtype": "bfloat16", "refine_steps": 6},
            "swept_unix": 1754300000.0}}}

The port keeps its own file: ``$GAUSS_TORCH_TUNE_STORE`` when set, else
``~/.cache/gauss_tpu_torch/tune_store.json``. Its fingerprint names
``torch`` where the JAX package's names ``jax``
(:data:`FINGERPRINT_KEYS`), read from the port's
:func:`gauss_tpu_torch.obs.registry.environment_fingerprint`, which never
starts CUDA. A fingerprint that names ``jax`` was stamped by the JAX
package and never matches here.

Failure policy, as in the JAX package: a corrupt, truncated, wrong-version
or foreign store never changes behaviour. The strict loader
(:meth:`TuneStore.load`) raises the typed :class:`TuneStoreError`; the
consult path (:mod:`gauss_tpu_torch.tune.apply`) catches it and runs the
seeds. The sweep that writes stores is not ported yet; :meth:`TuneStore.put`
and :meth:`TuneStore.save` exist so that a store can be written by hand or
by a test.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional

from gauss_tpu_torch.tune import space as _space

STORE_VERSION = 1

#: Environment variable naming the store file.
ENV_STORE = "GAUSS_TORCH_TUNE_STORE"

#: Fingerprint fields that key a store to a hardware epoch.
FINGERPRINT_KEYS = ("backend", "device_kind", "device_count", "torch")

#: A fingerprint with one of these fields was stamped by the JAX package.
FOREIGN_KEYS = ("jax",)


class TuneStoreError(RuntimeError):
    """The store file cannot be used: unreadable, corrupt JSON, missing
    fields, an unknown schema version. Consult paths catch this and run
    the seeds; strict callers let it propagate."""


def default_store_path() -> str:
    """``$GAUSS_TORCH_TUNE_STORE`` when set, else a per-user cache path
    (not inside the repository: a checkout behaves the same on every
    machine until a store is written on it)."""
    env = os.environ.get(ENV_STORE)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "gauss_tpu_torch",
                        "tune_store.json")


def store_fingerprint() -> Dict[str, Any]:
    """The reduced fingerprint for stamping and matching. Starts nothing;
    a process that has not imported torch has no ``torch`` or ``backend``
    field, and one that has not initialized CUDA says ``backend="cpu"``."""
    from gauss_tpu_torch.obs.registry import environment_fingerprint

    fp = environment_fingerprint()
    return {k: fp[k] for k in FINGERPRINT_KEYS if fp.get(k) is not None}


def cuda_pending(current: Dict[str, Any]) -> bool:
    """Whether ``current`` says ``cpu`` only because CUDA is not
    initialized yet in this process (the card may still be the one a
    ``cuda``-stamped store was measured on)."""
    torch = sys.modules.get("torch")
    return (current.get("backend") == "cpu" and torch is not None
            and torch.cuda.is_available()
            and not torch.cuda.is_initialized())


def fingerprint_matches(stamped: Dict[str, Any],
                        current: Optional[Dict[str, Any]] = None) -> bool:
    """Does a store stamped with ``stamped`` apply to this process? Never
    when it was stamped by the JAX package; else strict on the fields both
    sides know, as in the JAX package."""
    if any(k in stamped for k in FOREIGN_KEYS):
        return False
    current = store_fingerprint() if current is None else current
    for k in FINGERPRINT_KEYS:
        if k in stamped and stamped[k] != current.get(k):
            return False
    return True


class TuneStore:
    """In-memory image of one store file."""

    def __init__(self, fingerprint: Optional[Dict[str, Any]] = None,
                 configs: Optional[Dict[str, Dict[str, Any]]] = None,
                 created_unix: Optional[float] = None):
        self.version = STORE_VERSION
        self.fingerprint = dict(fingerprint or {})
        self.configs: Dict[str, Dict[str, Any]] = dict(configs or {})
        self.created_unix = (time.time() if created_unix is None
                             else created_unix)

    def to_doc(self) -> Dict[str, Any]:
        return {"version": self.version, "fingerprint": self.fingerprint,
                "created_unix": self.created_unix, "configs": self.configs}

    @classmethod
    def from_doc(cls, doc: Any, path: str = "<doc>") -> "TuneStore":
        if not isinstance(doc, dict):
            raise TuneStoreError(f"tune store {path!r}: expected a JSON "
                                 f"object, got {type(doc).__name__}")
        version = doc.get("version")
        if version != STORE_VERSION:
            raise TuneStoreError(
                f"tune store {path!r}: schema version {version!r} is not "
                f"the supported version {STORE_VERSION} — regenerate it")
        configs = doc.get("configs")
        fingerprint = doc.get("fingerprint")
        if not isinstance(configs, dict) or not isinstance(fingerprint,
                                                           dict):
            raise TuneStoreError(
                f"tune store {path!r}: missing/invalid 'configs' or "
                f"'fingerprint' field")
        for key, entry in configs.items():
            if (not isinstance(entry, dict)
                    or not isinstance(entry.get("params"), dict)):
                raise TuneStoreError(
                    f"tune store {path!r}: config {key!r} has no valid "
                    f"'params' dict")
        return cls(fingerprint=fingerprint, configs=configs,
                   created_unix=doc.get("created_unix"))

    @classmethod
    def load(cls, path) -> "TuneStore":
        """Strict load: every failure is a :class:`TuneStoreError` with the
        original error chained."""
        path = os.fspath(path)
        try:
            with open(path) as f:
                text = f.read()
        except OSError as e:
            raise TuneStoreError(f"tune store {path!r}: cannot read: "
                                 f"{e}") from e
        try:
            doc = json.loads(text)
        except ValueError as e:
            raise TuneStoreError(
                f"tune store {path!r}: corrupt/truncated JSON ({e}) — "
                f"falling back to seed defaults is safe") from e
        return cls.from_doc(doc, path)

    def save(self, path) -> str:
        """Atomic write (temporary file + rename), stable key order."""
        path = os.fspath(path)
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_doc(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path

    def put(self, op: str, n: int, params: Dict[str, Any],
            dtype: str = "float32", engine: str = "blocked") -> str:
        key = _space.config_key(op, n, dtype, engine)
        self.configs[key] = {"params": dict(params),
                             "swept_unix": time.time()}
        return key

    def get(self, op: str, n: int, dtype: str = "float32",
            engine: str = "blocked") -> Optional[Dict[str, Any]]:
        """The stored entry for the (op, n-bucket, dtype, engine) point,
        or None."""
        return self.configs.get(_space.config_key(op, n, dtype, engine))

    def params(self, op: str, n: int, dtype: str = "float32",
               engine: str = "blocked") -> Dict[str, Any]:
        """Seed defaults overlaid with the stored winners for this point."""
        out = _space.seed_params(op)
        entry = self.get(op, n, dtype, engine)
        if entry:
            out.update(entry["params"])
        return out
