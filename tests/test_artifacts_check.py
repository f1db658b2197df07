"""Docs-vs-artifacts consistency gate for the fidelity records.

Fails the suite when a docs/FIDELITY.md number diverges from the
sample_results artifact that backs it, when a committed artifact breaks an
invariant its prose relies on, or when a config knob cites PERF.md for a
measurement PERF.md does not hold.  Pure file parsing — no JAX, runs in
milliseconds.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))


def test_doc_claims_match_artifacts():
    from artifacts_check import run_checks

    failures = run_checks(verbose=False)
    assert not failures, "\n".join(failures)


def test_front_page_claims():
    """Every config knob citing PERF.md is named there (no dangling
    measurement citations), and no committed artifact's note contradicts
    its own fields."""
    from artifacts_check import check_note_contradictions, check_perf_citations

    failures = check_perf_citations(verbose=False)
    failures += check_note_contradictions(verbose=False)
    assert not failures, "\n".join(failures)


def test_readme_test_count():
    """README's quoted test count matches live pytest collection (~17s)."""
    from artifacts_check import check_test_count

    failures = check_test_count(verbose=False)
    assert not failures, "\n".join(failures)
