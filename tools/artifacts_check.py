"""Artifact-claim consistency check for the fidelity records.

Every fidelity number quoted in docs/FIDELITY.md must match the committed
artifact a reader would open to verify it (`sample_results/*/summary.json`
etc.) within a stated tolerance, and each committed fidelity artifact must
satisfy the invariants its prose relies on.  Speed numbers are not checked
here: PERF.md holds them, each beside the card it was measured on.

Each check is (doc, regex-with-one-group, artifact, extractor, rel_tol).
The regex anchors on surrounding prose so a reworded doc fails loudly
(missing match) instead of silently skipping.

Run directly (`python tools/artifacts_check.py`) or via
tests/test_artifacts_check.py.  Exit code 1 on any mismatch.
"""

import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _load(rel):
    with open(ROOT / rel) as f:
        return json.load(f)


def _doc(rel):
    return (ROOT / rel).read_text()


# (doc, pattern, artifact, key_fn, rel_tol).  key_fn maps the parsed
# artifact JSON to the number the doc claims.
CHECKS = [
    # --- full-UK epidemic capability artifact ------------------------------
    (None, None,
     "sample_results/full_uk_epidemic/summary.json",
     lambda a: 1.0 if (a["steps_run"] == 5000
                       and a["n_citizens"] == 63_000_000) else 0.0,
     ("full-UK epidemic ran the complete 5000-hour horizon at 63M", 1.0)),
    # --- York pipeline envelope gate (sample_results/york_pipeline) --------
    (None, None,
     "sample_results/york_pipeline/summary.json",
     lambda a: 1.0 if (
         a.get("envelope_gate")
         and all(v["inside"] for v in a["envelope_gate"].values())
     ) else 0.0,
     ("york_pipeline epidemic inside the 32-seed v1.6 envelope", 1.0)),
    # --- v1.6 fidelity gate (sample_results/york_v16) ----------------------
    ("docs/FIDELITY.md",
     r"(\d+) runs \(\d+ world seeds x \d+ sim seeds each",
     "sample_results/york_v16/summary.json",
     lambda a: a["n_seeds"], 0.0),
    (None, None,
     "sample_results/york_v16/summary.json",
     lambda a: 1.0 if all(a["inside_envelope"].values()) else 0.0,
     ("v1.6 envelope closed (every gate quantity inside the seed band)",
      1.0)),
    ("docs/FIDELITY.md",
     r"infected curve inside the seed band for[\s*]+([\d.]+)% of hours",
     "sample_results/york_v16/curve_gate.json",
     lambda a: round(100 * a["infected"]["coverage_pointwise"], 1), 0.005),
    ("docs/FIDELITY.md",
     r"nRMSE vs the seed median[\s*]+([\d.]+)",
     "sample_results/york_v16/curve_gate.json",
     lambda a: a["infected"]["nrmse"]["vs_median"], 0.005),
    # --- V-gate LOO bound + rate-corrected V coverage (round 5) -----------
    ("docs/FIDELITY.md",
     r"\[0\.589, 1\.0\] for vaccinated \((\d+)/32 below",
     "sample_results/york_v16/curve_gate.json",
     lambda a: a["vaccinated"]["self_coverage_loo"]["seeds_below_canonical"],
     0.0),
    (None, None,
     "sample_results/york_v16/curve_gate.json",
     lambda a: 1.0 if (
         a["vaccinated"]["coverage_pointwise"] >= 0.999
         and a["vaccinated"]["self_coverage_loo"]["min"]
         <= a["vaccinated"]["coverage_pointwise"]
     ) else 0.0,
     ("canonical V coverage is 100% pointwise under the corrected "
      "vaccination rate", 1.0)),
    # --- real-world validation (round 5) ----------------------------------
    (None, None,
     "sample_results/real_validation/summary.json",
     lambda a: 1.0 if (
         "1.0" in a.get("calibration_to_real_wave", {})
         and "0.25" in a["calibration_to_real_wave"]
         and 0 < a["calibration_to_real_wave"]["1.0"]["value"] < 0.003
     ) else 0.0,
     ("real-wave calibration committed at both ascertainments with a fit "
      "below the v1.6 constant", 1.0)),
    ("docs/FIDELITY.md",
     r"it lands at \*\*([\d.]+)e-4 — 11\.6× below the v1\.6 constant",
     "sample_results/real_validation/summary.json",
     lambda a: round(
         a["calibration_to_real_wave"]["1.0"]["value"] * 1e4, 2
     ), 0.005),
    # --- Y&H pipeline + log gate (round 5) --------------------------------
    ("docs/FIDELITY.md",
     r"peak infected \*\*([\d.]+)% vs the\s+reference's\s+53\.2%\*\*",
     "sample_results/yh_pipeline/log_gate.json",
     lambda a: round(100 * a["sim_anatomy_band"]["peak_I_frac"][1], 1), 0.0),
    (None, None,
     "sample_results/yh_pipeline/log_gate.json",
     lambda a: 1.0 if (
         a["n_seeds"] >= 5
         and abs(a["sim_anatomy_band"]["attack_frac"][1]
                 - a["reference_anatomy"]["attack_frac"]) < 0.07
         and abs(a["sim_anatomy_band"]["peak_I_frac"][1]
                 - a["reference_anatomy"]["peak_I_frac"]) < 0.07
     ) else 0.0,
     ("Y&H log-gate anatomy within 7pp of the reference's own run", 1.0)),
]


def check_perf_citations(verbose=True):
    """Dangling-citation check: every SimConfig field whose `#:` doc
    comment cites PERF.md must itself be named in PERF.md — a config knob
    claiming a measurement with no PERF.md entry behind it fails."""
    failures = []
    cfg_src = _doc("epidemicsimulator_tpu/config.py")
    perf = _doc("PERF.md")
    for m in re.finditer(
        r"((?:^[ \t]*#:.*\n)+)[ \t]*(\w+)\s*:", cfg_src, re.M
    ):
        comment, field = m.group(1), m.group(2)
        if "PERF.md" not in comment:
            continue
        ok = field in perf
        if verbose:
            print(f"{'ok ' if ok else 'FAIL'} config.{field} cites PERF.md"
                  f"{'' if ok else ' but PERF.md never names it'}")
        if not ok:
            failures.append(
                f"config.py field '{field}' cites PERF.md but PERF.md "
                f"never names it (dangling measurement citation)"
            )
    return failures


def check_test_count(verbose=True, timeout=180):
    """README's quoted test count must match live pytest collection."""
    import subprocess

    text = _doc("README.md")
    m = re.search(r"(\d+) tests incl", text)
    if not m:
        return ["README.md: test-count claim ('<N> tests incl') not found"]
    claimed = int(m.group(1))
    try:
        out = subprocess.run(
            [sys.executable, "-m", "pytest", "tests", "--collect-only", "-q"],
            capture_output=True, text=True, cwd=ROOT, timeout=timeout,
        ).stdout
    except subprocess.TimeoutExpired:
        return []  # collection hung; don't fail the gate on infra
    mm = re.search(r"(\d+) tests collected", out)
    if not mm:
        return [f"pytest collection failed: {out[-300:]}"]
    actual = int(mm.group(1))
    ok = claimed == actual
    if verbose:
        print(f"{'ok ' if ok else 'FAIL'} README test count {claimed} vs "
              f"collected {actual}")
    return [] if ok else [
        f"README.md claims {claimed} tests; pytest collects {actual}"
    ]


def check_note_contradictions(verbose=True):
    """Self-contradicting artifacts gate: a summary.json whose prose note claims extinction ("S+E+I = 0",
    "to extinction", "epidemic over") while its own fields record
    ``epidemic_over: false`` fails the suite."""
    import glob

    failures = []
    claims = re.compile(
        r"S\s*\+\s*E\s*\+\s*I\s*=\s*0|to extinction\b|epidemic (is |was )?over",
        re.I,
    )
    for path in sorted(glob.glob(str(ROOT / "sample_results/**/*.json"),
                                 recursive=True)):
        try:
            a = json.loads(Path(path).read_text())
        except (json.JSONDecodeError, UnicodeDecodeError):
            continue
        if not isinstance(a, dict) or a.get("epidemic_over") is not False:
            continue
        note = str(a.get("note", ""))
        rel = str(Path(path).relative_to(ROOT))
        ok = not claims.search(note)
        if verbose:
            print(f"{'ok ' if ok else 'FAIL'} {rel}: note consistent with "
                  f"epidemic_over=false")
        if not ok:
            failures.append(
                f"{rel}: note claims extinction but epidemic_over is false"
            )
    return failures


def run_checks(checks=CHECKS, verbose=True):
    failures = []
    for doc, pattern, artifact, key_fn, tol in checks:
        try:
            art = _load(artifact)
        except FileNotFoundError:
            failures.append(f"{artifact}: missing")
            continue
        want = key_fn(art)
        if doc is None:
            # invariant check on the artifact itself: key_fn returns 1.0
            # when the invariant holds; tol carries (description, expected)
            desc, expected = tol
            ok = want == expected
            if verbose:
                print(f"{'ok ' if ok else 'FAIL'} {artifact}: {desc}")
            if not ok:
                failures.append(f"{artifact}: invariant failed: {desc}")
            continue
        text = _doc(doc)
        m = re.search(pattern, text, re.S)
        if not m:
            failures.append(f"{doc}: claim not found: /{pattern[:60]}.../")
            continue
        got = float(m.group(1).replace(",", ""))
        ok = (got == want) if tol == 0.0 else (
            abs(got - want) <= tol * max(abs(want), 1e-9)
        )
        if verbose:
            print(f"{'ok ' if ok else 'FAIL'} {doc}: quotes {got} vs "
                  f"{artifact} {round(want, 4)} (tol {tol})")
        if not ok:
            failures.append(
                f"{doc}: quotes {got}, artifact {artifact} says "
                f"{round(want, 4)} (tol {tol})"
            )
    return failures


def main():
    failures = run_checks()
    failures += check_perf_citations()
    failures += check_note_contradictions()
    failures += check_test_count()
    if failures:
        print("\nARTIFACT/CLAIM MISMATCHES:")
        for f in failures:
            print(" -", f)
        return 1
    print("all artifact claims consistent")
    return 0


if __name__ == "__main__":
    sys.exit(main())
