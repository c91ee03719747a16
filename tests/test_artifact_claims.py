"""Machine check: every measurement artifact the repo's records claim
must actually exist in git.

Three consecutive rounds committed prose claiming artifacts
(`KSWEEP_r3.json`, `SPGEMM_STUDY_r4.json`, `DEGREE_SWEEP_r4.json`, ...)
that were never produced — forward-looking statements written before a
campaign ran and never corrected when it died. Prose discipline failed;
this test makes the claim class fail CI instead:

1. Every `*_r<N>.json` filename mentioned anywhere in the repo's prose
   (STATUS.md, README.md, PARITY.md, docs/*.md) or source docstrings
   must be a git-tracked file — unless the mention is on the explicit
   NEGATIVE list below AND its line textually says the artifact does
   not exist (the honest way to discuss a gap).
2. docs/ARTIFACTS.md's "committed" column (built in r4 expressly so
   that stale instance claims "can't recur", ARTIFACTS.md:10-13) is
   parsed row by row: each listed instance token must expand to a
   git-tracked file.

Adding a new claim therefore requires producing the artifact first, or
consciously editing the negative list here — either way the claim is
reviewed against reality, not intentions.
"""

from __future__ import annotations

import re
import subprocess
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# artifact mentions that legitimately refer to files that DON'T exist:
# each must sit on a line that says so (negation check below)
KNOWN_NEGATIVE = {
    "KSWEEP_r3.json",
    "SPGEMM_STUDY_r3.json",
    "DEGREE_SWEEP_r3.json",
    "DEGREE_SWEEP_r4.json",
    "SPGEMM_STUDY_r4.json",
}
NEGATION = re.compile(
    r"never produced|never ran|was never|was ever produced|"
    r"does not exist|do not exist|"
    r"doesn't exist|no [A-Z_]+_r\d+\.json|nonexistent|claimed-but-missing",
    re.IGNORECASE,
)

ARTIFACT = re.compile(r"\b[A-Za-z0-9_]+_r\d+\.json\b")

PROSE = ["STATUS.md", "README.md", "PARITY.md", "BASELINE.md"]


def _tracked() -> set:
    out = subprocess.run(
        ["git", "ls-files"], cwd=REPO, capture_output=True, text=True,
        check=True,
    ).stdout
    return set(out.split())


def _scan_files():
    files = [REPO / p for p in PROSE if (REPO / p).exists()]
    files += sorted((REPO / "docs").glob("*.md"))
    files += sorted((REPO / "maxk_gnn").rglob("*.py"))
    for name in ("bench.py", "train.py", "chip_smoke.py"):
        if (REPO / name).exists():
            files.append(REPO / name)
    return files


def test_every_claimed_artifact_exists():
    tracked = _tracked()
    problems = []
    for path in _scan_files():
        for i, line in enumerate(
            path.read_text(errors="replace").splitlines(), 1
        ):
            for name in ARTIFACT.findall(line):
                where = f"{path.relative_to(REPO)}:{i}"
                if name in tracked:
                    continue
                if name in KNOWN_NEGATIVE:
                    if not NEGATION.search(line):
                        problems.append(
                            f"{where}: {name} is on the negative list "
                            f"but the line doesn't say it's missing: "
                            f"{line.strip()!r}"
                        )
                    continue
                problems.append(
                    f"{where}: claims {name}, which is not in git"
                )
    assert not problems, "stale artifact claims:\n" + "\n".join(problems)


def test_artifacts_md_committed_column():
    """Each instance token in docs/ARTIFACTS.md's committed column must
    expand (template `{N}` -> token digits) to a git-tracked file."""
    art = REPO / "docs" / "ARTIFACTS.md"
    tracked = _tracked()
    problems = []
    rows = 0
    for line in art.read_text().splitlines():
        m = re.match(r"\|\s*`([A-Za-z0-9_]+_r)\{N\}(\.json)`\s*\|([^|]*)\|",
                     line)
        if not m:
            continue
        prefix, suffix, committed = m.group(1), m.group(2), m.group(3)
        rows += 1
        for tok in re.findall(r"\br(\d+)\b", committed):
            name = f"{prefix}{tok}{suffix}"
            if name not in tracked:
                problems.append(
                    f"ARTIFACTS.md lists {name} as committed; not in git"
                )
    assert rows >= 5, "ARTIFACTS.md table not found / format changed"
    assert not problems, "\n".join(problems)
