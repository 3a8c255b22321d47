"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.
Tests that need the card carry the ``cuda`` marker and skip here."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
