"""Face reenactment CLI, video to video (port of ``scripts/vid2vid.py``).

    python -m aniportrait_tpu_torch.scripts.vid2vid --config ./configs/prompts/animation_facereenac.yaml

Same flags and output as the JAX package's CLI.  Per source frame the
landmark extractor gives the head pose, the canonical mesh and the
blendshapes; :func:`retarget_pose_and_expression` moves the pose onto the
reference (euler angles, translation relative to the first frame, moving
average over 3 frames) and the expression onto the reference's mesh (the
delta from the most neutral source frame); the projected vertices are drawn
as the pose video.  A 60 fps source is halved to 30 fps.  Each case writes
a 3-row (reference / result / source) grid mp4, with the source's audio
muxed in where ffmpeg is present.  The models run on the card unless
``--device cpu`` asks for the CPU.  ``-acc`` takes landmarks from every
``--fi_step``-th source frame and FiLM-interpolates the frames between, as
``pose2vid`` does.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

from aniportrait_tpu_torch.config import load_config
from aniportrait_tpu_torch.scripts.pose2vid import (
    add_common_args,
    fit,
    generate,
    load_pipe,
    output_dir,
    reference_pose,
    sub_step,
)
from aniportrait_tpu_torch.utils.draw_util import FaceMeshVisualizer
from aniportrait_tpu_torch.utils.frame_interpolation import init_for_cli
from aniportrait_tpu_torch.utils.mp_utils import LMKExtractor
from aniportrait_tpu_torch.utils.pose_util import (
    euler_and_translation_to_matrix,
    matrix_to_euler_and_translation,
    project_points_with_trans,
    smooth_pose_seq,
)
from aniportrait_tpu_torch.utils.util import get_fps, mux_audio, read_frames, save_videos_grid


def parse_args(argv=None):
    parser = add_common_args(argparse.ArgumentParser(),
                             "./configs/prompts/animation_facereenac.yaml", None)
    return parser.parse_args(argv)


def retarget_pose_and_expression(source_results: list, ref_result: dict, frame_shape,
                                 smooth_window: int = 3):
    """The vid2vid retargeting math (reference vid2vid.py:174-197).

    Returns projected 2D vertices (L, N, 2) for the target pose images."""
    trans_mat_arr = np.array([r["trans_mat"] for r in source_results])
    verts_arr = np.array([r["lmks3d"] for r in source_results])
    bs_arr = np.array([r["bs"] for r in source_results])
    min_bs_idx = np.argmin(bs_arr.sum(1))

    pose_arr = np.zeros([trans_mat_arr.shape[0], 6])
    for i in range(pose_arr.shape[0]):
        euler, trans = matrix_to_euler_and_translation(trans_mat_arr[i])
        pose_arr[i, :3] = euler
        pose_arr[i, 3:6] = trans

    init_tran_vec = np.array(ref_result["trans_mat"])[:3, 3]
    pose_arr[:, 3:6] = pose_arr[:, 3:6] - pose_arr[0, 3:6] + init_tran_vec

    pose_arr_smooth = smooth_pose_seq(pose_arr, window_size=smooth_window)
    pose_mat_smooth = np.array([
        euler_and_translation_to_matrix(pose_arr_smooth[i][:3], pose_arr_smooth[i][3:6])
        for i in range(pose_arr_smooth.shape[0])
    ])

    verts_arr = verts_arr - verts_arr[min_bs_idx] + np.array(ref_result["lmks3d"])
    return project_points_with_trans(verts_arr, pose_mat_smooth, frame_shape)


def prepare_case(ref_rgb: np.ndarray, source_images, src_fps: float, args,
                 lmk_extractor, vis) -> tuple:
    """(case, output fps) from a decoded RGB reference image and source
    video; the case also carries the grid's source frames (``src_frames``).
    Landmarks are taken from the first ``-L`` source frames (after halving a
    60 fps source; every ``--fi_step``-th of them under ``-acc``) up to the
    first frame without a face."""
    import cv2

    face_result, ref_pose = reference_pose(ref_rgb, args, lmk_extractor, vis)
    step = 1
    if src_fps == 60:
        src_fps, step = 30, 2
    last = len(source_images) if args.L is None else args.L * step
    source_results = []
    frame_shape = source_images[0].shape[:2]
    for src_rgb in source_images[:last:step * sub_step(args)]:
        src_bgr = cv2.cvtColor(src_rgb, cv2.COLOR_RGB2BGR)
        frame_shape = src_bgr.shape[:2]
        res = lmk_extractor(src_bgr)
        if res is None:
            break
        source_results.append(res)

    projected = retarget_pose_and_expression(source_results, face_result,
                                             list(frame_shape))
    pose_list = [
        fit(vis.draw_landmarks((frame_shape[1], frame_shape[0]), verts, normed=False),
            args.W, args.H)
        for verts in projected
    ]
    case = dict(ref_image=ref_rgb, pose_images=pose_list, ref_pose_image=ref_pose,
                kw=dict(video_length=len(pose_list)),
                src_frames=source_images[:last:step])
    return case, src_fps


def reenact_grid(case: dict, video: np.ndarray, width: int, height: int) -> np.ndarray:
    """(3, L, H, W, 3) float rows: reference, result, source."""
    ref_row = np.repeat((fit(case["ref_image"], width, height).astype(np.float32)
                         / 255)[None], video.shape[0], axis=0)
    src_row = np.stack([fit(f, width, height).astype(np.float32) / 255
                        for f in case["src_frames"][: video.shape[0]]])
    return np.stack([ref_row, video, src_row[: video.shape[0]]])


def main(argv=None):
    args = parse_args(argv)
    import cv2

    interpolator = init_for_cli(args.fi_weights, args.device) if args.accelerate else None
    config = load_config(args.config)
    pipe = load_pipe(config, args)
    save_dir, time_str = output_dir(args)
    lmk_extractor = LMKExtractor()
    vis = FaceMeshVisualizer(forehead_edge=False)

    cases, metas = [], []
    for ref_image_path, source_video_paths in config["test_cases"].items():
        for source_video_path in source_video_paths:
            ref_rgb = cv2.cvtColor(cv2.imread(ref_image_path), cv2.COLOR_BGR2RGB)
            case, src_fps = prepare_case(ref_rgb, read_frames(source_video_path),
                                         get_fps(source_video_path), args,
                                         lmk_extractor, vis)
            cases.append(case)
            metas.append(dict(ref_name=Path(ref_image_path).stem,
                              pose_name=Path(source_video_path).stem, src_fps=src_fps,
                              source_video_path=source_video_path))

    for key, grid in generate(pipe, cases, args, reenact_grid, interpolator):
        meta = metas[key]
        noaudio = (f"{save_dir}/{meta['ref_name']}_{meta['pose_name']}"
                   f"_{args.H}x{args.W}_{int(args.cfg)}_{time_str}_noaudio.mp4")
        save_videos_grid(grid, noaudio,
                         fps=meta["src_fps"] if args.fps is None else args.fps)
        final = noaudio.replace("_noaudio.mp4", ".mp4")
        if mux_audio(noaudio, meta["source_video_path"], final):
            os.remove(noaudio)
            print(f"saved {final}")
        else:
            print(f"saved {noaudio} (no ffmpeg for audio mux)")


if __name__ == "__main__":
    main()
