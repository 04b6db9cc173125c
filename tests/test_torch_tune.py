"""The port's tune read side (``gauss_tpu_torch.tune``) against the JAX
package's: the seeds and keys, the store schema, the port's own
fingerprint, and the consults ``core.blocked`` makes."""

import json

import pytest
import torch

from gauss_tpu.tune import space as jspace
from gauss_tpu.tune import store as jstore
from gauss_tpu_torch import obs
from gauss_tpu_torch.core import blocked as tb
from gauss_tpu_torch.tune import apply as tapply
from gauss_tpu_torch.tune import space as tspace
from gauss_tpu_torch.tune import store as tstore


@pytest.fixture
def store_path(tmp_path, monkeypatch):
    """A private store path for the test, with the consult cache reset
    before and after."""
    path = tmp_path / "tune_store.json"
    monkeypatch.setenv(tstore.ENV_STORE, str(path))
    tapply.reset_cache()
    yield path
    tapply.reset_cache()


@pytest.mark.parametrize("op", ["lowered", "lu_factor", "panel_fused",
                                "sparse"])
def test_seeds_and_axes_match_jax(op):
    assert tspace.seed_params(op) == jspace.seed_params(op)
    assert ([(a.name, a.seed, a.values(), a.sweep_default)
             for a in tspace.space_for(op)]
            == [(a.name, a.seed, a.values(), a.sweep_default)
                for a in jspace.space_for(op)])
    assert (tspace.LOWERED_DTYPE_SEED, tspace.LOWERED_REFINE_SEED) == (
        jspace.LOWERED_DTYPE_SEED, jspace.LOWERED_REFINE_SEED)
    assert tspace.CHUNK_SEED == jspace.CHUNK_SEED == tb.CHUNK_DEFAULT


@pytest.mark.parametrize("op,n,dtype,engine", [
    ("lowered", 2048, "float32", "blocked"), ("lowered", 3000, "bfloat16",
                                              "blocked"),
    ("lu_factor", 1, "float32", "blocked"), ("lu_factor", 8193, "bf16x3",
                                             "serve"),
    ("panel_fused", 100, "float32", "blocked")])
def test_config_key_matches_jax(op, n, dtype, engine):
    assert tspace.config_key(op, n, dtype, engine) == jspace.config_key(
        op, n, dtype, engine)
    assert tspace.n_bucket(n) == jspace.n_bucket(n)


def test_unknown_op_raises():
    with pytest.raises(KeyError, match="unknown tunable op"):
        tspace.space_for("nope")


def test_store_doc_in_shared_schema_loads(tmp_path):
    """A document written by the JAX package's TuneStore loads into the
    port's, and the port's round-trips; bad documents raise the typed
    error."""
    path = tmp_path / "jax.json"
    js = jstore.TuneStore(fingerprint={"backend": "cpu"})
    js.put("lowered", 2048, {"dtype": "bfloat16", "refine_steps": 4})
    js.save(path)
    st = tstore.TuneStore.load(path)
    assert st.params("lowered", 2048) == js.params("lowered", 2048)
    assert st.get("lowered", 1025)["params"]["refine_steps"] == 4
    st.save(tmp_path / "port.json")
    again = jstore.TuneStore.load(tmp_path / "port.json")
    assert again.configs == st.configs
    for bad in ("[1]", "{", json.dumps({"version": 2}),
                json.dumps({"version": 1, "configs": {}})):
        (tmp_path / "bad.json").write_text(bad)
        with pytest.raises(tstore.TuneStoreError):
            tstore.TuneStore.load(tmp_path / "bad.json")
    with pytest.raises(tstore.TuneStoreError, match="cannot read"):
        tstore.TuneStore.load(tmp_path / "missing.json")


def test_fingerprint_names_torch_and_jax_stamps_never_match():
    fp = tstore.store_fingerprint()
    assert set(fp) <= set(tstore.FINGERPRINT_KEYS)
    assert fp["torch"] == torch.__version__ and "jax" not in fp
    assert fp["backend"] in ("cpu", "cuda")
    assert tstore.fingerprint_matches(dict(fp))
    jax_stamp = {"backend": fp["backend"], "jax": "0.9.0"}
    assert not tstore.fingerprint_matches(jax_stamp)
    assert not tstore.fingerprint_matches(dict(fp, torch="0.0"))


def test_no_store_returns_seeds(store_path):
    assert not store_path.exists()
    assert tapply.override("lu_factor", 8192, "chunk") is None
    assert tapply.params_for("lowered", 2048) == tspace.seed_params(
        "lowered")
    assert tapply.param("lu_factor", 2048, "chunk") == tspace.CHUNK_SEED
    assert tapply.store_status() == {"path": str(store_path),
                                     "usable": False, "reason": "absent",
                                     "configs": 0}


def test_store_overrides_panel_and_chunk(store_path):
    """A store stamped with this process's fingerprint feeds auto_panel and
    resolve_factor's chunk; a JAX-stamped one is ignored with its reason."""
    st = tstore.TuneStore(fingerprint=tstore.store_fingerprint())
    st.put("lu_factor", 8192, {"chunk": 2})
    st.put("lu_factor", 2048, {"panel": 64})
    st.put("lowered", 2048, {"dtype": "bfloat16", "refine_steps": 4})
    st.save(store_path)
    assert tapply.store_status()["usable"]
    assert tb.auto_panel(2048) == 64
    assert tb.auto_panel(8192) == 256
    f = tb.resolve_factor(8192, "auto", device="cpu")
    assert f.func is tb.lu_factor_blocked_chunked and f.keywords == {
        "chunk": 2}
    assert tapply.params_for("lowered", 1500) == {"dtype": "bfloat16",
                                                  "refine_steps": 4}
    with tapply.suspended():
        assert tb.auto_panel(2048) == 256
        assert tapply.override("lu_factor", 8192, "chunk") is None
    st.fingerprint = {"backend": "cpu", "jax": "0.9.0"}
    st.save(store_path)
    tapply.reset_cache()
    assert tapply.store_status()["reason"] == "fingerprint_mismatch"
    assert tb.auto_panel(2048) == 256
    assert tb.resolve_factor(8192, "auto", device="cpu") is (
        tb.lu_factor_blocked_chunked)


def test_corrupt_store_falls_back_with_event(store_path, tmp_path):
    store_path.write_text("{not json")
    stream = tmp_path / "m.jsonl"
    with obs.run(metrics_out=str(stream), tool="test"):
        assert tapply.params_for("lowered", 64) == tspace.seed_params(
            "lowered")
        assert tapply.params_for("lowered", 64) == tspace.seed_params(
            "lowered")
    events = [e for e in obs.read_events(str(stream)) if e["type"] == "tune"]
    assert len(events) == 1 and events[0]["source"] == "seed"
    assert events[0]["reason"].startswith("store_error")
    assert events[0]["key"] == "lowered/n64/float32/blocked"


def test_cuda_stamped_store_waits_for_the_card(store_path, monkeypatch):
    """A card-stamped store read before CUDA starts is judged again at the
    next consult, never cached as a mismatch."""
    st = tstore.TuneStore(fingerprint={"backend": "cuda",
                                       "torch": torch.__version__})
    st.put("lu_factor", 2048, {"panel": 64})
    st.save(store_path)
    monkeypatch.setattr(tstore, "cuda_pending", lambda current: True)
    assert tapply.store_status()["reason"] == "backend_uninitialized"
    assert tapply.override("lu_factor", 2048, "panel") is None
    monkeypatch.setattr(tstore, "cuda_pending", lambda current: False)
    assert tapply.store_status()["reason"] == (
        "ok" if torch.cuda.is_initialized() else "fingerprint_mismatch")


def test_package_exports_and_default_path(monkeypatch):
    from gauss_tpu_torch import tune

    assert tune.TuneStore is tstore.TuneStore
    assert tune.TuneStoreError is tstore.TuneStoreError
    monkeypatch.delenv(tstore.ENV_STORE, raising=False)
    assert tstore.default_store_path().endswith(
        ".cache/gauss_tpu_torch/tune_store.json")
    assert tstore.ENV_STORE != jstore.ENV_STORE
