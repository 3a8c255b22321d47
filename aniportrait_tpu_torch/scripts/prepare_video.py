"""Face crop + pose drawing of a video (the port's copy of the JAX
package's ``scripts/prepare_video.py``): every frame cropped square around
the face and resized to ``--size``, its pose map drawn; frames without a
face are skipped.  Host only (OpenCV):

    python -m aniportrait_tpu_torch.scripts.prepare_video --video_path video.mp4 \
        [--out_dir DIR] [--size 512]

writes ``<name>_crop.mp4`` and ``<name>_pose.mp4``."""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    import cv2

    from aniportrait_tpu_torch.utils.draw_util import FaceMeshVisualizer
    from aniportrait_tpu_torch.utils.mp_utils import LMKExtractor
    from aniportrait_tpu_torch.utils.util import crop_face, get_fps, read_frames, write_video

    parser = argparse.ArgumentParser()
    parser.add_argument("--video_path", type=str, required=True)
    parser.add_argument("--out_dir", type=str, default=None)
    parser.add_argument("--size", type=int, default=512)
    args = parser.parse_args(argv)

    out_dir = args.out_dir or os.path.dirname(args.video_path)
    name = os.path.splitext(os.path.basename(args.video_path))[0]
    os.makedirs(out_dir, exist_ok=True)

    lmk_extractor = LMKExtractor()
    vis = FaceMeshVisualizer(forehead_edge=False)

    fps = get_fps(args.video_path)
    frames = read_frames(args.video_path)

    cropped_frames, pose_frames = [], []
    for frame_rgb in frames:
        bgr = cv2.cvtColor(frame_rgb, cv2.COLOR_RGB2BGR)
        cropped = crop_face(bgr, lmk_extractor)
        if cropped is None:
            continue
        cropped = cv2.resize(cropped, (args.size, args.size))
        result = lmk_extractor(cropped)
        if result is None:
            continue
        lmks = np.array(result["lmks"]).astype(np.float32)
        pose = vis.draw_landmarks((args.size, args.size), lmks, normed=True)
        cropped_frames.append(cv2.cvtColor(cropped, cv2.COLOR_BGR2RGB))
        pose_frames.append(cv2.cvtColor(pose, cv2.COLOR_BGR2RGB))

    write_video(cropped_frames, os.path.join(out_dir, f"{name}_crop.mp4"), fps)
    write_video(pose_frames, os.path.join(out_dir, f"{name}_pose.mp4"), fps)
    print(f"wrote {len(cropped_frames)} frames to {out_dir}")


if __name__ == "__main__":
    main()
