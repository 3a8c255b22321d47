"""General IO utilities (host-side, cv2-based).

The port's copy of ``aniportrait_tpu/utils/util.py`` (held to it by
``tests/test_torch_copies.py``).

Parity target: reference ``src/utils/util.py`` — video read/write, grid
writer, landmark-driven square face crop (the JAX module's seeding and
checkpoint GC belong to training and are not copied).  The
reference uses PyAV; this build uses cv2 (libav is not in the image) with
the same frame semantics (RGB numpy in, RGB out), falling back to ffmpeg
subprocess for audio muxing when available.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional

import numpy as np


def read_frames(video_path: str) -> List[np.ndarray]:
    """Decode all frames as RGB uint8 arrays."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    return frames


def get_fps(video_path: str) -> float:
    import cv2

    cap = cv2.VideoCapture(video_path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return fps


def write_video(frames: List[np.ndarray], path: str, fps: float = 30.0):
    """frames: RGB uint8 arrays -> mp4 (or .gif via PIL)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".gif"):
        from PIL import Image

        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(
            path, save_all=True, append_images=imgs[1:],
            duration=int(1000 / fps), loop=0,
        )
        return
    import cv2

    h, w = frames[0].shape[:2]
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    writer = cv2.VideoWriter(path, fourcc, fps, (w, h))
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()


def save_videos_grid(videos: np.ndarray, path: str, fps: float = 30.0):
    """videos: (n_rows, L, H, W, 3) float [0,1] or uint8 -> stacked grid mp4
    (reference util.py:52-104 writes ref/pose/result rows stacked)."""
    if videos.dtype != np.uint8:
        videos = (np.clip(videos, 0, 1) * 255).astype(np.uint8)
    L = videos.shape[1]
    frames = [np.concatenate([videos[r, i] for r in range(videos.shape[0])], axis=0)
              for i in range(L)]
    write_video(frames, path, fps)


def mux_audio(video_path: str, audio_path: str, out_path: str) -> bool:
    """Remux source audio onto a video via ffmpeg if present
    (reference scripts/audio2vid.py:262-265).  Returns success."""
    if shutil.which("ffmpeg") is None:
        return False
    cmd = [
        "ffmpeg", "-y", "-i", video_path, "-i", audio_path,
        "-map", "0:v", "-map", "1:a", "-c:v", "copy", "-shortest", out_path,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        return True
    except subprocess.CalledProcessError:
        return False


def crop_face(img: np.ndarray, lmk_extractor, expand: float = 1.5) -> Optional[np.ndarray]:
    """Landmark-driven square face crop with 1.5x expansion
    (reference util.py:131-181).  img: BGR uint8 (cv2 convention)."""
    import cv2

    result = lmk_extractor(img)
    if result is None:
        return None

    H, W, _ = img.shape
    lmks = np.array(result["lmks"], dtype=np.float64).copy()
    lmks[:, 0] *= W
    lmks[:, 1] *= H

    x_min, x_max = np.min(lmks[:, 0]), np.max(lmks[:, 0])
    y_min, y_max = np.min(lmks[:, 1]), np.max(lmks[:, 1])
    width, height = x_max - x_min, y_max - y_min

    if width * height >= W * H * 0.15:
        if W == H:
            return img
        size = min(H, W)
        offset = int((max(H, W) - size) / 2)
        return img[:, offset:-offset] if size == H else img[offset:-offset, :]

    center_x = x_min + width / 2
    center_y = y_min + height / 2
    width *= expand
    height *= expand
    size = max(width, height)
    x_min = int(center_x - size / 2)
    x_max = int(center_x + size / 2)
    y_min = int(center_y - size / 2)
    y_max = int(center_y + size / 2)
    top = max(0, -y_min)
    bottom = max(0, y_max - img.shape[0])
    left = max(0, -x_min)
    right = max(0, x_max - img.shape[1])
    img = cv2.copyMakeBorder(
        img, top, bottom, left, right, cv2.BORDER_CONSTANT, value=0
    )
    return img[y_min + top : y_max + top, x_min + left : x_max + left]
