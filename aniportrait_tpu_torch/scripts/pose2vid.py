"""Pose-video-driven generation CLI (port of ``scripts/pose2vid.py``).

    python -m aniportrait_tpu_torch.scripts.pose2vid --config ./configs/prompts/animation.yaml -W 512 -H 512

Same flags and output as the JAX package's CLI: the prompt YAML's
``test_cases`` map reference images to pose videos; each case writes a
3-row (reference / pose / result) grid mp4 under ``output/``.  The models
run on the card unless ``--device cpu`` asks for the CPU.

The work splits into functions that the smoke run and the tests call as
``main`` does: :func:`prepare_case` (host: resize, landmarks of the
reference, its pose drawing; OpenCV) turns decoded arrays into a pipeline
case, and :func:`generate` runs the cases through ``run_cases`` and yields
each result's grid, built without OpenCV when the frames are already at the
output size.

``-acc`` diffuses every ``--fi_step``-th pose frame and fills the frames
between with FiLM (``utils/frame_interpolation.py``; ``--fi_weights``, or
the reference's ``./pretrained_model/film_net_fp16.pt``; without weights a
loud cross-fade), the clip staying on the device between the two; those
cases run one after another, not through ``run_cases``.
"""

from __future__ import annotations

import argparse
from datetime import datetime
from pathlib import Path

import numpy as np

from aniportrait_tpu_torch.config import load_config
from aniportrait_tpu_torch.scripts.loader import load_pipeline
from aniportrait_tpu_torch.utils.draw_util import FaceMeshVisualizer
from aniportrait_tpu_torch.utils.frame_interpolation import (
    batch_images_interpolation_tool,
    init_for_cli,
)
from aniportrait_tpu_torch.utils.mp_utils import LMKExtractor
from aniportrait_tpu_torch.utils.util import get_fps, read_frames, save_videos_grid


def add_common_args(parser: argparse.ArgumentParser, default_config: str,
                    default_fps) -> argparse.ArgumentParser:
    """The flags pose2vid and vid2vid share (``scripts/pose2vid.py:18-56``),
    and ``--device``."""
    parser.add_argument("--config", type=str, default=default_config)
    parser.add_argument("-W", type=int, default=512)
    parser.add_argument("-H", type=int, default=512)
    parser.add_argument("-L", type=int, default=None)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--cfg", type=float, default=3.5)
    parser.add_argument("--steps", type=int, default=25)
    parser.add_argument(
        "--encoder_cache", type=int, default=1,
        help="refresh the UNet's down/mid features every k-th denoise step "
             "(k > 1 is an approximation, gated by utils/quality_gate.py)")
    parser.add_argument(
        "--window_fusion", action="store_true",
        help="opt-in overlap-aware long-clip mode: one whole-clip UNet pass "
             "per step, motion modules window internally (quality-gated "
             "approximation)")
    parser.add_argument(
        "--context_rotate", action="store_true",
        help="rotate the context window table per denoise step (opt-in "
             "experiment, not the reference's behaviour; quality-gated)")
    parser.add_argument(
        "--force_approx", action="store_true",
        help="run approximations past the measured quality gate (encoder "
             "cache k >= 3)")
    parser.add_argument("--fps", type=int, default=default_fps)
    parser.add_argument("-acc", "--accelerate", action="store_true",
                        help="diffuse every --fi_step-th frame, FiLM-interpolate between")
    parser.add_argument("--fi_step", type=int, default=3)
    parser.add_argument("--fi_weights", type=str, default=None,
                        help="FiLM net weights (.pt TorchScript or converted .npz)")
    parser.add_argument("--device", default="cuda",
                        help="where the models run: cuda (default) or cpu")
    return parser


def parse_args(argv=None):
    parser = add_common_args(argparse.ArgumentParser(),
                             "./configs/prompts/animation.yaml", 30)
    return parser.parse_args(argv)


def fit(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(image, (width, height))``; an image already at that size
    is returned as it is (OpenCV copies it unchanged), without OpenCV."""
    if image.shape[:2] == (height, width):
        return image
    import cv2

    return cv2.resize(image, (width, height))


def load_pipe(config, args):
    """The CLIs' pipeline: ``load_pipeline`` with the approximation flags."""
    return load_pipeline(config, encoder_cache_interval=args.encoder_cache,
                         window_fusion=args.window_fusion,
                         context_rotate=args.context_rotate,
                         force_approx=args.force_approx, device=args.device)


def reference_pose(ref_rgb: np.ndarray, args, lmk_extractor, vis):
    """(face result, pose drawing) of the reference image, resized as the
    reference CLI does (``cv2.resize(..., (H, W))``)."""
    import cv2

    ref_bgr = cv2.resize(cv2.cvtColor(ref_rgb, cv2.COLOR_RGB2BGR), (args.H, args.W))
    face_result = lmk_extractor(ref_bgr)
    if face_result is None:
        raise ValueError("No face detected in the reference image.")
    lmks = np.array(face_result["lmks"]).astype(np.float32)
    pose = vis.draw_landmarks((ref_bgr.shape[1], ref_bgr.shape[0]), lmks, normed=True)
    return face_result, pose


def sub_step(args) -> int:
    """The stride of the diffused frames: ``--fi_step`` under ``-acc``."""
    return args.fi_step if args.accelerate else 1


def prepare_case(ref_rgb: np.ndarray, pose_frames, args, lmk_extractor, vis) -> dict:
    """A ``run_cases`` case from a decoded RGB reference image and pose
    video: the first ``-L`` pose frames resized to ``-W x -H``, of which
    every ``--fi_step``-th is diffused under ``-acc`` (``pose_row``: all of
    them, for the grid)."""
    _, ref_pose = reference_pose(ref_rgb, args, lmk_extractor, vis)
    length = len(pose_frames) if args.L is None else args.L
    pose_row = [fit(f, args.W, args.H) for f in pose_frames[:length]]
    pose_list = pose_row[::sub_step(args)]
    return dict(ref_image=ref_rgb, pose_images=pose_list, ref_pose_image=ref_pose,
                kw=dict(video_length=len(pose_list)), pose_row=pose_row)


def pose_grid(case: dict, video: np.ndarray, width: int, height: int) -> np.ndarray:
    """(3, L, H, W, 3) float rows: reference, pose, result."""
    ref_row = np.repeat((fit(case["ref_image"], width, height).astype(np.float32)
                         / 255)[None], video.shape[0], axis=0)
    poses = case.get("pose_row", case["pose_images"])[: video.shape[0]]
    pose_row = np.stack([p.astype(np.float32) / 255 for p in poses])
    return np.stack([ref_row, pose_row, video])


def generate(pipe, cases, args, grid=pose_grid, interpolator=None):
    """Run ``cases`` through ``pipe.run_cases`` (case i+1's upload and case
    i-1's download overlap case i's denoise) and yield ``(index, grid)``
    per case, in order.  Under ``-acc`` each case runs on its own and its
    clip goes to ``interpolator`` (default ``init_for_cli(--fi_weights)``)
    on the device, ``--fi_step - 1`` frames between each pair."""
    if args.accelerate:
        yield from _generate_acc(pipe, cases, args, grid, interpolator)
        return
    cases = [dict(c, key=i) for i, c in enumerate(cases)]
    for key, video in pipe.run_cases(cases, args.W, args.H,
                                     num_inference_steps=args.steps,
                                     guidance_scale=args.cfg, seed=args.seed):
        yield key, grid(cases[key], video, args.W, args.H)


def _generate_acc(pipe, cases, args, grid, interpolator):
    if interpolator is None:
        interpolator = init_for_cli(args.fi_weights, args.device)
    on_device = getattr(interpolator, "device_io", False)
    for key, case in enumerate(cases):
        video = pipe(case["ref_image"], case["pose_images"], case.get("ref_pose_image"),
                     args.W, args.H, case["kw"]["video_length"], args.steps, args.cfg,
                     seed=args.seed, return_device=on_device)
        video = batch_images_interpolation_tool(video, interpolator,
                                                inter_frames=args.fi_step - 1)[0]
        yield key, grid(case, video, args.W, args.H)


def output_dir(args) -> tuple:
    now = datetime.now()
    save_dir = Path(f"output/{now:%Y%m%d}/{now:%H%M}--seed_{args.seed}-{args.W}x{args.H}")
    save_dir.mkdir(exist_ok=True, parents=True)
    return save_dir, f"{now:%H%M}"


def main(argv=None):
    args = parse_args(argv)
    import cv2

    # the interpolator first: a FiLM path that does not load fails before
    # any diffusion model is built
    interpolator = init_for_cli(args.fi_weights, args.device) if args.accelerate else None
    config = load_config(args.config)
    pipe = load_pipe(config, args)
    save_dir, time_str = output_dir(args)
    lmk_extractor = LMKExtractor()
    vis = FaceMeshVisualizer(forehead_edge=False)

    # host preparation of every case first, so that run_cases can overlap
    # one case's IO with another's denoise
    cases, metas = [], []
    for ref_image_path, pose_video_paths in config["test_cases"].items():
        for pose_video_path in pose_video_paths:
            ref_rgb = cv2.cvtColor(cv2.imread(ref_image_path), cv2.COLOR_BGR2RGB)
            cases.append(prepare_case(ref_rgb, read_frames(pose_video_path), args,
                                      lmk_extractor, vis))
            metas.append(dict(ref_name=Path(ref_image_path).stem,
                              pose_name=Path(pose_video_path).stem.replace("_kps", ""),
                              src_fps=get_fps(pose_video_path)))

    for key, grid in generate(pipe, cases, args, interpolator=interpolator):
        meta = metas[key]
        save_path = (f"{save_dir}/{meta['ref_name']}_{meta['pose_name']}"
                     f"_{args.H}x{args.W}_{int(args.cfg)}_{time_str}.mp4")
        save_videos_grid(grid, save_path,
                         fps=meta["src_fps"] if args.L is None else args.fps)
        print(f"saved {save_path}")


if __name__ == "__main__":
    main()
