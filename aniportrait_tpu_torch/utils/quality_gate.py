"""Quality gate of the opt-in approximations, the port's copy of
``aniportrait_tpu/utils/quality_gate.py`` (the table loader,
:func:`enforce_approximation_gate` and :func:`check_regression`).

The pipeline has two opt-in approximations (``pipelines/pose2vid.py``):
``encoder_cache_interval`` (down + mid features reused between refreshes)
and ``window_fusion`` (motion-module-internal overlap averaging), and the
``context_rotate`` experiment.  Their divergence from the exact path is the
table in the repository's ``docs/quality_gate*.json``, read here as files.
Those dB were measured on the JAX package's path; the port's approximations
are held to that path by the parity tests of
``tests/test_torch_pipeline_options.py``, and
``scripts/quality_speed_gate.py --check`` measures the port's own rows on
the card and holds them to the table (:func:`check_regression`).
The entry points call :func:`enforce_approximation_gate`, which prints the
measured dB with every approximate run and refuses encoder cache k >= 3
without ``force``.

Policy (the JAX package's, from that table): window fusion and encoder
cache k=2 are allowed and reported; encoder cache k >= 3 is refused
without ``force`` until a real-weights LPIPS gate passes
(docs/WEIGHTS_RUNBOOK.md step 3).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

# divergence regression tolerances for --check (a kernel change that
# silently hurts an approximate path should fail CI, not ship)
PSNR_REGRESSION_DB = 1.5
SSIM_REGRESSION = 0.002


def _docs_dir() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.normpath(os.path.join(here, "..", "..", "docs"))


def load_gate_table(table_dir: Optional[str] = None) -> Dict[str, dict]:
    """Merge every ``docs/quality_gate*.json`` into {mode: row}; later
    files (lexicographically — r3 < r4 < ...) win on duplicate modes."""
    table_dir = table_dir or _docs_dir()
    merged: Dict[str, dict] = {}
    for path in sorted(glob.glob(os.path.join(table_dir, "quality_gate*.json"))):
        try:
            with open(path) as f:
                rows = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        for row in rows:
            if isinstance(row, dict) and "mode" in row:
                merged[row["mode"]] = row
    return merged


def _lookup(table: Dict[str, dict], needle: str) -> Optional[dict]:
    """Most recent row whose mode contains ``needle`` and has a psnr."""
    hits = [r for m, r in table.items() if needle in m and r.get("psnr")]
    return hits[-1] if hits else None


def enforce_approximation_gate(
    encoder_cache_interval: int = 1,
    window_fusion: bool = False,
    context_rotate: bool = False,
    force: bool = False,
    table_dir: Optional[str] = None,
    _print=print,
) -> List[str]:
    """Apply the measured gate policy; returns the warnings it printed.

    Raises ``ValueError`` for encoder cache k >= 3 unless ``force``.
    """
    k = int(encoder_cache_interval)
    warnings: List[str] = []
    if k <= 1 and not window_fusion and not context_rotate:
        return warnings
    table = load_gate_table(table_dir)

    def warn(msg: str):
        warnings.append(msg)
        _print(f"[quality gate] {msg}")

    if window_fusion:
        row = _lookup(table, "window fusion")
        if row:
            warn(
                "window fusion is an overlap-averaging approximation: "
                f"measured {row['psnr']:.1f} dB PSNR / {row['ssim']:.4f} SSIM "
                "vs the exact path (below visible-difference thresholds; "
                "BASELINE.md quality table)"
            )
        else:
            warn(
                "window fusion is an approximation and no measured gate "
                "table was found under docs/ — run "
                "scripts/quality_speed_gate.py before production use"
            )
    if context_rotate:
        row = _lookup(table, "context rotate")
        if row:
            warn(
                "context rotation departs from the reference's fixed "
                f"step-0 window table: measured {row['psnr']:.1f} dB PSNR "
                f"/ {row['ssim']:.4f} SSIM vs the step-0 exact path "
                "(BASELINE.md quality table)"
            )
        else:
            warn(
                "context rotation is an unmeasured table-phase experiment "
                "— run scripts/quality_speed_gate.py before production use"
            )
    if k == 2:
        row = _lookup(table, "encoder cache k=2")
        if row:
            warn(
                "encoder cache k=2: measured "
                f"{row['psnr']:.1f} dB PSNR / {row['ssim']:.4f} SSIM vs "
                "exact — gated for preview/draft use (BASELINE.md)"
            )
        else:
            warn(
                "encoder cache k=2 is an approximation and no measured "
                "gate table was found under docs/"
            )
    elif k >= 3:
        row = _lookup(table, f"encoder cache k={k}") or _lookup(
            table, "encoder cache k=3"
        )
        measured = (
            f"measured {row['psnr']:.1f} dB PSNR / {row['ssim']:.4f} SSIM"
            if row
            else "unmeasured divergence"
        )
        if not force:
            raise ValueError(
                f"encoder cache k={k} shows drift beyond the gated regime "
                f"({measured} vs exact at k=3; policy keeps k <= 2 until a "
                "real-weights LPIPS gate passes — docs/WEIGHTS_RUNBOOK.md). "
                "Pass --force_approx to run anyway."
            )
        warn(f"encoder cache k={k} FORCED past the gate ({measured} at k=3)")
    return warnings


def check_regression(
    fresh_rows: List[dict], table_dir: Optional[str] = None
) -> List[str]:
    """Compare freshly measured gate rows against the stored table;
    returns a list of regression messages (empty = pass).  Used by
    ``scripts/quality_speed_gate.py --check``."""
    table = load_gate_table(table_dir)
    problems = []
    for row in fresh_rows:
        if not row.get("psnr"):
            continue
        base = table.get(row["mode"]) or _lookup(table, row["mode"])
        if not base or not base.get("psnr"):
            continue
        if row["psnr"] < base["psnr"] - PSNR_REGRESSION_DB:
            problems.append(
                f"{row['mode']}: PSNR regressed {base['psnr']:.2f} -> "
                f"{row['psnr']:.2f} dB (tolerance {PSNR_REGRESSION_DB})"
            )
        if row["ssim"] < base["ssim"] - SSIM_REGRESSION:
            problems.append(
                f"{row['mode']}: SSIM regressed {base['ssim']:.4f} -> "
                f"{row['ssim']:.4f} (tolerance {SSIM_REGRESSION})"
            )
    return problems
