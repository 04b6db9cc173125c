"""The port's poison-the-server campaign (``gauss_tpu_torch.serve
.poisoncheck``) on the CPU, against the JAX package's: the same poison
systems from the same seeds, every in-process isolation kind giving the
same verdict and counts for the same seed in both packages, the verdict
checker reading the same journals alike, the history records, the mesh
leg refused by name (``--no-mesh`` the default), and the crash-loop leg's
four incarnations broken by the quarantine. Arrays, verdicts and counts
are compared equal."""

import numpy as np
import pytest

from gauss_tpu.serve import poisoncheck as jcheck
from gauss_tpu.serve.cache import ExecutableCache as JExecutableCache
from gauss_tpu_torch.resilience.inject import KILL_EXIT_CODE
from gauss_tpu_torch.serve import poisoncheck
from gauss_tpu_torch.serve.cache import ExecutableCache

CPU = "cpu"
GATE = 1e-4
SEED = 777201


@pytest.fixture(scope="module")
def caches():
    return (poisoncheck._TrippingCache(ExecutableCache(64, device=CPU)),
            jcheck._TrippingCache(JExecutableCache(64)))


@pytest.mark.parametrize("kind", poisoncheck.POISON_KINDS)
def test_poison_systems_equal_the_jax_packages(kind):
    a, b = poisoncheck.poison_system(np.random.default_rng(3), 12, kind)
    ja, jb = jcheck.poison_system(np.random.default_rng(3), 12, kind)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)


@pytest.mark.parametrize("kind", poisoncheck.POISON_KINDS)
def test_isolation_case_verdicts_equal_the_jax_packages(kind, caches,
                                                        tmp_path):
    i = poisoncheck.POISON_KINDS.index(kind)
    got = poisoncheck.run_case(i, SEED, GATE, str(tmp_path / "t"), kind,
                               cache=caches[0], device=CPU)
    want = jcheck.run_case(i, SEED, GATE, str(tmp_path / "j"), kind,
                           cache=caches[1])
    assert got == want
    assert got["outcome"] == "ok"


def test_verdict_checker_reads_journals_as_the_jax_package(caches,
                                                           tmp_path):
    poisoncheck.run_case(2, 5, GATE, str(tmp_path), "singular",
                         cache=caches[0], device=CPU)
    jd = str(tmp_path / "case-singular-002" / "journal")
    got = poisoncheck.journal_records([jd])
    assert got == jcheck.journal_records([jd])
    admits, terms = got
    assert any(t[0]["status"] == "poison" for t in terms.values())
    assert poisoncheck._audit_pill(jd, "absent", GATE) == \
        jcheck._audit_pill(jd, "absent", GATE)


def test_history_records_and_the_mesh_leg_refusal(capsys):
    summ = {"wall_s": 12.0, "cases": 31}
    assert poisoncheck.history_records(summ) == jcheck.history_records(summ)
    assert poisoncheck.build_parser().parse_args([]).mesh is False
    assert poisoncheck.main(["--device", CPU, "--mesh"]) == 2
    assert "serve/lanes" in capsys.readouterr().err


def test_crash_loop_is_broken_by_the_quarantine(tmp_path):
    """The kill-on-dispatch pill re-armed for four incarnations: two die
    torn, the third replays it solo on the host ladder with the fault
    still armed, the fourth replays nothing; one ok terminal."""
    leg = poisoncheck.run_crashloop_leg(SEED, GATE, str(tmp_path),
                                        device=CPU, log=lambda _m: None)
    assert leg["outcome"] == "ok", leg.get("error")
    assert [i["rc"] for i in leg["incarnations"]] == [
        KILL_EXIT_CODE, KILL_EXIT_CODE, 0, 0]


def test_campaign_cli_in_process_with_history(tmp_path, capsys):
    hist = tmp_path / "h.jsonl"
    rc = poisoncheck.main(["--device", CPU, "--cases", "4",
                           "--no-subprocess", "--history", str(hist),
                           "--regress-check"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "invariant HOLDS" in out and "record(s) appended" in out
