"""Video -> pose-video converter (the port's copy of the JAX package's
``scripts/vid2pose.py``, after the reference's ``scripts/vid2pose.py``):
per-frame landmarks on the frame resized to 512x512, the pose map drawn
from them, the previous frame's pose map where no face is found; audio
remuxed when ffmpeg is present.  Host only (OpenCV), no card:

    python -m aniportrait_tpu_torch.scripts.vid2pose --video_path video.mp4

writes ``video_kps.mp4`` (``video_kps_noaudio.mp4`` without ffmpeg) beside
the video."""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    import cv2

    from aniportrait_tpu_torch.utils.draw_util import FaceMeshVisualizer
    from aniportrait_tpu_torch.utils.mp_utils import LMKExtractor
    from aniportrait_tpu_torch.utils.util import get_fps, mux_audio, read_frames, write_video

    parser = argparse.ArgumentParser()
    parser.add_argument("--video_path", type=str, required=True)
    args = parser.parse_args(argv)

    if not os.path.exists(args.video_path):
        raise ValueError(f"Path: {args.video_path} not exists")

    dir_path = os.path.dirname(args.video_path)
    video_name = os.path.splitext(os.path.basename(args.video_path))[0]
    out_path = os.path.join(dir_path, video_name + "_kps_noaudio.mp4")

    lmk_extractor = LMKExtractor()
    vis = FaceMeshVisualizer(forehead_edge=False)
    width = height = 512

    fps = get_fps(args.video_path)
    frames = read_frames(args.video_path)
    kps_results = []
    for frame_rgb in frames:
        image_np = cv2.resize(
            cv2.cvtColor(frame_rgb, cv2.COLOR_RGB2BGR), (height, width)
        )
        face_result = lmk_extractor(image_np)
        try:
            lmks = np.array(face_result["lmks"]).astype(np.float32)
            pose_img = vis.draw_landmarks(
                (image_np.shape[1], image_np.shape[0]), lmks, normed=True
            )
            pose_img = cv2.cvtColor(pose_img, cv2.COLOR_BGR2RGB)
        except (TypeError, KeyError):
            # no face: reuse the previous pose frame (vid2pose.py:41-46)
            pose_img = kps_results[-1]
        kps_results.append(pose_img)

    write_video(kps_results, out_path, fps=fps)
    final = out_path.replace("_noaudio.mp4", ".mp4")
    if mux_audio(out_path, args.video_path, final):
        os.remove(out_path)
        print(final)
    else:
        print(out_path)


if __name__ == "__main__":
    main()
