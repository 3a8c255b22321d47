"""Head-pose template for audio2vid (the port's copy of the JAX package's
``scripts/generate_ref_pose.py``, after the reference's): each frame's
trans_mat as the pose relative to frame 0 (Euler angles and translation),
interpolated to 30 fps, smoothed, saved as ``.npy`` (audio2vid's
``pose_temp``).  Host only (OpenCV, scipy):

    python -m aniportrait_tpu_torch.scripts.generate_ref_pose \
        --ref_video_path video.mp4 --save_path pose_temp.npy
"""

from __future__ import annotations

import argparse

import numpy as np
from scipy.interpolate import interp1d


def main(argv=None):
    import cv2

    from aniportrait_tpu_torch.utils.mp_utils import LMKExtractor
    from aniportrait_tpu_torch.utils.pose_util import (
        matrix_to_euler_and_translation,
        smooth_pose_seq,
    )

    parser = argparse.ArgumentParser()
    parser.add_argument("--ref_video_path", type=str, required=True)
    parser.add_argument("--save_path", type=str, required=True)
    args = parser.parse_args(argv)

    lmk_extractor = LMKExtractor()
    cap = cv2.VideoCapture(args.ref_video_path)
    fps = cap.get(cv2.CAP_PROP_FPS)

    trans_mat_list = []
    while cap.isOpened():
        ret, frame = cap.read()
        if not ret:
            break
        result = lmk_extractor(frame)
        if result is None:
            break
        trans_mat_list.append(np.array(result["trans_mat"]).astype(np.float32))
    cap.release()

    trans_mat_arr = np.array(trans_mat_list)
    total_frames = len(trans_mat_arr)

    # delta pose vs frame 0
    trans_mat_inv_frame_0 = np.linalg.inv(trans_mat_arr[0])
    pose_arr = np.zeros([total_frames, 6])
    for i in range(total_frames):
        pose_mat = trans_mat_inv_frame_0 @ trans_mat_arr[i]
        euler, trans = matrix_to_euler_and_translation(pose_mat)
        pose_arr[i, :3] = euler
        pose_arr[i, 3:6] = trans

    # interpolate to 30 fps
    new_fps = 30
    old_time = np.linspace(0, total_frames / fps, total_frames)
    new_time = np.linspace(0, total_frames / fps, int(total_frames * new_fps / fps))
    pose_arr_interp = np.zeros((len(new_time), 6))
    for i in range(6):
        pose_arr_interp[:, i] = interp1d(old_time, pose_arr[:, i])(new_time)

    pose_arr_smooth = smooth_pose_seq(pose_arr_interp)
    np.save(args.save_path, pose_arr_smooth)
    print(f"saved {args.save_path} ({len(pose_arr_smooth)} frames @30fps)")


if __name__ == "__main__":
    main()
