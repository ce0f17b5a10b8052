"""The reference-citation audit of ``tests/test_citation_audit.py``, run
over the PyTorch port (``spectral_tpu_torch/``) and ``chip_smoke.py``.

The port's docstrings and comments cite the reference app as the JAX
package's do (``GUI.py:87-90`` for the GUI's nperseg range,
``PlotEngine.py:113-135`` for the display it reproduces), so its parity
claims are checkable the same way. Two checks:

- always: every citation names one of the reference's four files with a
  well-formed range, and lies within the lines that the JAX package's own
  citations (held to the reference by ``tests/test_citation_audit.py``)
  show the file to have;
- with the reference checkout (``tests/reference_exec.py``; skipped
  inside the test when it is absent): every citation resolves as that
  audit resolves the JAX package's: the file exists, the range lies
  inside it, and the cited lines are not all blank.
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest

import reference_exec

REPO = Path(__file__).resolve().parent.parent

# tests/test_citation_audit.py's pattern
_CITE = re.compile(r"\b(PlotEngine|GUI|SweepManager|ExportManager)\.py:"
                   r"(\d+)(?:-(\d+))?")


def _citations(paths):
    for src in paths:
        text = src.read_text()
        for m in _CITE.finditer(text):
            line_no = text[: m.start()].count("\n") + 1
            yield (src.relative_to(REPO), line_no, m.group(1) + ".py",
                   int(m.group(2)), int(m.group(3)) if m.group(3) else None)


def _port_citations():
    return list(_citations(
        sorted((REPO / "spectral_tpu_torch").rglob("*.py"))
        + [REPO / "chip_smoke.py"]))


def test_port_citations_lie_within_the_audited_reference_lines():
    """At least ten citations (the port cites GUI.py, PlotEngine.py,
    ExportManager.py and SweepManager.py); each range ascends and ends
    at or before the last line that the JAX package cites in that file."""
    audited = {}
    for _, _, ref_file, lo, hi in _citations(
            sorted((REPO / "spectral_tpu").rglob("*.py"))
            + [REPO / "bench.py", REPO / "__graft_entry__.py"]):
        audited[ref_file] = max(audited.get(ref_file, 0), hi or lo)
    cites = _port_citations()
    assert len(cites) >= 10
    assert {c[2] for c in cites} == {"GUI.py", "PlotEngine.py",
                                     "ExportManager.py", "SweepManager.py"}
    bad = [f"{src}:{line} -> {ref_file}:{lo}" + (f"-{hi}" if hi else "")
           for src, line, ref_file, lo, hi in cites
           if not (1 <= lo <= (hi or lo) <= audited.get(ref_file, 0))]
    assert not bad, "citations past the audited lines:\n" + "\n".join(bad)


def test_port_citations_resolve_against_the_reference():
    if not reference_exec.available():
        pytest.skip("reference checkout not available")
    ref = reference_exec.REF_DIR
    lines = {p.name: p.read_text().splitlines() for p in ref.glob("*.py")}
    bad = []
    for src, line_no, ref_file, lo, hi in _port_citations():
        where = f"{src}:{line_no} -> {ref_file}:{lo}" + (
            f"-{hi}" if hi else "")
        text = lines.get(ref_file)
        if text is None:
            bad.append(f"{where}: no such reference file")
        elif not 1 <= lo <= (hi or lo) <= len(text):
            bad.append(f"{where}: outside the file's {len(text)} lines")
        elif not any(s.strip() for s in text[lo - 1:hi or lo]):
            bad.append(f"{where}: cited lines are blank")
    assert not bad, "stale reference citations:\n" + "\n".join(bad)
