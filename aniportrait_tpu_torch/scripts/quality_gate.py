"""Quality gate: compare two clips frame by frame (port of ``scripts/quality_gate.py``).

    python -m aniportrait_tpu_torch.scripts.quality_gate OURS.mp4 REFERENCE.mp4 \
        [--lpips-weights lpips_alex.npz] [--min-psnr DB] [--max-lpips D] [--out report.json]

Inputs may be video files (any cv2-readable container) or directories of
same-named frames.  Frames are compared index-aligned; the clips must have
the same length and resolution (the protocol is same seed, same noise, same
conditioning, so a mismatch is an error).  Reading video needs OpenCV, so
the CLI runs where OpenCV is installed; LPIPS runs on ``--device`` (the
card unless ``--device cpu``).  The LPIPS ``.npz`` is converted once from
the official checkpoints with
``aniportrait_tpu_torch.utils.quality.convert_lpips_weights`` (the weights
are not in the repository).  Exit code 1 when a ``--min-psnr`` or
``--max-lpips`` bound fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from aniportrait_tpu_torch.utils.quality import compare_videos


def load_frames(path: str) -> np.ndarray:
    """(F, H, W, 3) uint8 RGB frames of a video file or a frame directory."""
    import cv2

    if os.path.isdir(path):
        names = sorted(os.listdir(path))
        frames = [cv2.imread(os.path.join(path, n)) for n in names]
        frames = [f for f in frames if f is not None]
    else:
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
        cap.release()
    if not frames:
        raise SystemExit(f"no frames read from {path!r}")
    return np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2RGB) for f in frames])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ours")
    ap.add_argument("reference")
    ap.add_argument("--lpips-weights", default=os.environ.get("LPIPS_WEIGHTS"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--min-psnr", type=float, default=None,
                    help="fail (exit 1) if mean PSNR falls below this")
    ap.add_argument("--max-lpips", type=float, default=None,
                    help="fail (exit 1) if mean LPIPS exceeds this")
    ap.add_argument("--device", default="cuda",
                    help="where LPIPS runs: cuda (default) or cpu")
    args = ap.parse_args(argv)

    ours = load_frames(args.ours)
    ref = load_frames(args.reference)
    if ours.shape != ref.shape:
        raise SystemExit(
            f"shape mismatch: ours {ours.shape} vs reference {ref.shape} — "
            "the protocol requires same seed/length/resolution"
        )
    report = compare_videos(ours, ref, lpips_weights=args.lpips_weights, device=args.device)
    if args.lpips_weights and "lpips" not in report:
        print(f"warning: LPIPS weights not found at {args.lpips_weights!r}; "
              "reporting PSNR/SSIM only", file=sys.stderr)
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)

    ok = True
    if args.min_psnr is not None and report["psnr"] < args.min_psnr:
        ok = False
    if args.max_lpips is not None and report.get("lpips", 0.0) > args.max_lpips:
        ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
