"""The consult path: entry points ask here for their tuned config (the JAX
package's ``tune/apply.py``).

- **No change without a store.** When no store file exists,
  :func:`params_for` returns the seeds and :func:`override` None after one
  cached ``os.stat``.
- **Typed fallback.** A corrupt, stale or foreign store degrades to the
  seeds with an obs ``tune`` event naming the reason.
- **Process-stable.** The store is read once per process (first consult)
  and the resolution kept; tests call :func:`reset_cache`. A store stamped
  on the card, read before this process has initialized CUDA, is judged
  again at the next consult (``backend_uninitialized``), as the JAX
  package does before its backend starts.
- **Observable.** Each distinct (run, key, outcome) emits one ``tune``
  event and a ``tune.store_hits`` / ``tune.store_misses`` counter through
  :mod:`gauss_tpu_torch.obs`.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Dict, Optional, Tuple

from gauss_tpu_torch import obs
from gauss_tpu_torch.tune import space as _space
from gauss_tpu_torch.tune import store as _store

_lock = threading.Lock()
#: (path, store-or-None, reason), resolved once per process.
_resolved: Optional[Tuple[str, Optional[_store.TuneStore], str]] = None
#: (run_id, key, outcome) tuples already announced.
_announced: set = set()
_suspended = False


def reset_cache() -> None:
    """Forget the cached store resolution (tests, or after writing a new
    store in this process)."""
    global _resolved
    with _lock:
        _resolved = None
        _announced.clear()


@contextlib.contextmanager
def suspended():
    """Behave as if no store exists inside the block (a sweep measures its
    seed baseline this way)."""
    global _suspended
    prev = _suspended
    _suspended = True
    try:
        yield
    finally:
        _suspended = prev


def _judge(st: _store.TuneStore) -> Tuple[str, bool]:
    """(reason, cacheable) for a loaded store against this process."""
    stamped = st.fingerprint
    if any(k in stamped for k in _store.FOREIGN_KEYS):
        return "fingerprint_mismatch", True
    current = _store.store_fingerprint()
    if stamped.get("backend") == "cuda" and _store.cuda_pending(current):
        return "backend_uninitialized", False
    keys = _store.FINGERPRINT_KEYS
    if any(k in stamped and k in current and stamped[k] != current[k]
           for k in keys):
        return "fingerprint_mismatch", True
    if any(k in stamped and k not in current for k in keys):
        return "backend_uninitialized", False
    return "ok", True


def _resolve() -> Tuple[str, Optional[_store.TuneStore], str]:
    """(path, usable store or None, reason), cached for the process except
    while the fingerprint cannot be judged yet."""
    global _resolved
    with _lock:
        if _resolved is not None:
            return _resolved
        path = _store.default_store_path()
        st: Optional[_store.TuneStore] = None
        cache = True
        if not os.path.exists(path):
            reason = "absent"
        else:
            try:
                st = _store.TuneStore.load(path)
            except _store.TuneStoreError as e:
                st, reason = None, f"store_error: {e}"
            else:
                reason, cache = _judge(st)
                if reason != "ok":
                    st = None
        resolved = (path, st, reason)
        if cache:
            _resolved = resolved
        return resolved


def store_status() -> Dict[str, Any]:
    """The resolved store state (path / usable / reason / configs)."""
    path, st, reason = _resolve()
    return {"path": path, "usable": st is not None, "reason": reason,
            "configs": len(st.configs) if st is not None else 0}


def _announce(key: str, outcome: str, **fields) -> None:
    rec = obs.active()
    tag = (rec.run_id if rec is not None else None, key, outcome)
    with _lock:
        if tag in _announced:
            return
        _announced.add(tag)
    obs.counter("tune.store_hits" if outcome == "store"
                else "tune.store_misses")
    obs.emit("tune", key=key, source=outcome, **fields)


def params_for(op: str, n: int, dtype: str = "float32",
               engine: str = "blocked") -> Dict[str, Any]:
    """Seed defaults overlaid with this machine's stored winners for the
    (op, n-bucket, dtype, engine) point. Never raises, never None."""
    key = _space.config_key(op, n, dtype, engine)
    seeds = _space.seed_params(op)
    if _suspended:
        return seeds
    _, st, reason = _resolve()
    if st is None:
        if reason != "absent":
            _announce(key, "seed", reason=reason)
        return seeds
    entry = st.configs.get(key)
    if not entry:
        _announce(key, "seed", reason="no_entry")
        return seeds
    seeds.update(entry["params"])
    _announce(key, "store", params=entry["params"],
              swept=entry.get("swept_unix"), sweep_run=entry.get("source"))
    return seeds


def param(op: str, n: int, name: str, default: Any = None,
          dtype: str = "float32", engine: str = "blocked") -> Any:
    """One tuned parameter for the (op, n) point; ``default`` (then the
    declared seed) when the store has nothing to say."""
    value = params_for(op, n, dtype, engine).get(name)
    return default if value is None else value


def override(op: str, n: int, name: str, dtype: str = "float32",
             engine: str = "blocked") -> Any:
    """The store's value only: None unless a usable store carries an
    explicit winner for this (op, n-bucket, dtype, engine, param) point.
    For code whose fallback is its own module constant."""
    if _suspended:
        return None
    _, st, reason = _resolve()
    key = _space.config_key(op, n, dtype, engine)
    if st is None:
        if reason not in ("absent", "backend_uninitialized"):
            _announce(key, "seed", reason=reason)
        return None
    entry = st.configs.get(key)
    if not entry or name not in entry["params"]:
        return None
    _announce(key, "store", params=entry["params"],
              swept=entry.get("swept_unix"), sweep_run=entry.get("source"))
    return entry["params"][name]
