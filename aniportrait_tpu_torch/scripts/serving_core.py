"""Model-serving callbacks shared by the Gradio app (``scripts/app.py``) and
the stdlib HTTP server (``scripts/serve.py``); port of
``scripts/serving_core.py``.

The reference serves through a Gradio Blocks app only (reference
``scripts/app.py:146-404``): the models load once and the two callbacks run
the whole audio2vid / vid2vid flows inside the request.  These functions are
that flow.  The host side (face crop, landmarks, pose drawing, video IO)
needs OpenCV; :func:`animate` is the request's device part on arrays, which
runs where OpenCV is missing.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from datetime import datetime
from typing import Any, Optional

import numpy as np
import torch

from aniportrait_tpu_torch.config import Config, load_config
from aniportrait_tpu_torch.scripts.audio2vid import audio_case
from aniportrait_tpu_torch.scripts.loader import load_audio_models, load_pipeline, sub_config


@dataclass
class ServingModels:
    """Everything loaded once per process (reference app.py:36-101)."""

    pipe: Any  # Pose2VideoPipeline
    a2m: Any = None  # Audio2MeshModel
    a2p: Any = None  # Audio2PoseModel


def load_serving_models(config_path="./configs/prompts/animation_audio.yaml",
                        random_init: bool = False, size: str = "full",
                        dtype=torch.bfloat16, device="cuda") -> ServingModels:
    """The serving stack from a prompt config (a YAML path, or its settings
    as a ``Config``): the pipeline in ``dtype`` (bf16), the audio models in
    float32, all on ``device``.  ``random_init=True`` takes no file (seeded
    random weights, real architectures at ``size``)."""
    config = config_path if isinstance(config_path, Config) else load_config(config_path)
    a2m, a2p = load_audio_models(sub_config(config.audio_inference_config),
                                 random_init=random_init, device=device)
    pipe = load_pipeline(config, dtype=dtype, random_init=random_init, size=size,
                         device=device)
    return ServingModels(pipe=pipe, a2m=a2m, a2p=a2p)


def get_headpose_temp(input_video: str) -> np.ndarray:
    """A head-pose template from a driving video (reference
    app.py:103-144)."""
    import cv2
    from scipy.interpolate import interp1d

    from aniportrait_tpu_torch.utils.mp_utils import LMKExtractor
    from aniportrait_tpu_torch.utils.pose_util import (
        matrix_to_euler_and_translation,
        smooth_pose_seq,
    )

    lmk_extractor = LMKExtractor()
    cap = cv2.VideoCapture(input_video)
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
    total = len(trans_mat_arr)
    inv0 = np.linalg.inv(trans_mat_arr[0])
    pose_arr = np.zeros([total, 6])
    for i in range(total):
        euler, trans = matrix_to_euler_and_translation(inv0 @ trans_mat_arr[i])
        pose_arr[i, :3] = euler
        pose_arr[i, 3:6] = trans
    new_fps = 30
    old_time = np.linspace(0, total / fps, total)
    new_time = np.linspace(0, total / fps, int(total * new_fps / fps))
    interp = np.zeros((len(new_time), 6))
    for i in range(6):
        interp[:, i] = interp1d(old_time, pose_arr[:, i])(new_time)
    return smooth_pose_seq(interp)


def _prep_reference(ref_img_rgb: np.ndarray, size: int):
    """Crop the face, resize, take its landmarks and pose drawing.  Returns
    (ref_rgb, face_result, ref_pose, visualizer), or None when no face is
    found (reference app.py:168-183)."""
    import cv2

    from aniportrait_tpu_torch.utils.draw_util import FaceMeshVisualizer
    from aniportrait_tpu_torch.utils.mp_utils import LMKExtractor
    from aniportrait_tpu_torch.utils.util import crop_face

    lmk_extractor = LMKExtractor()
    vis = FaceMeshVisualizer(forehead_edge=False)
    bgr = cv2.cvtColor(np.asarray(ref_img_rgb), cv2.COLOR_RGB2BGR)
    cropped = crop_face(bgr, lmk_extractor)
    if cropped is None:
        return None
    ref_bgr = cv2.resize(cropped, (size, size))
    ref_rgb = cv2.cvtColor(ref_bgr, cv2.COLOR_BGR2RGB)
    face_result = lmk_extractor(ref_bgr)
    if face_result is None:
        return None
    lmks = np.array(face_result["lmks"]).astype(np.float32)
    ref_pose = vis.draw_landmarks((size, size), lmks, normed=True)
    return ref_rgb, face_result, ref_pose, vis


def _write_result(video, out_dir: str, prefix: str, audio_source: Optional[str]):
    from aniportrait_tpu_torch.utils.util import mux_audio, write_video

    os.makedirs(out_dir, exist_ok=True)
    stamp = datetime.now().strftime("%H%M%S_%f")
    noaudio = f"{out_dir}/{prefix}_{stamp}_noaudio.mp4"
    write_video([(f * 255).astype(np.uint8) for f in video], noaudio, fps=30)
    if audio_source:
        final = noaudio.replace("_noaudio.mp4", ".mp4")
        if mux_audio(noaudio, audio_source, final):
            os.remove(noaudio)
            return final
    return noaudio


def animate(models: ServingModels, sample: dict, face_result: dict, ref_rgb: np.ndarray,
            ref_pose: np.ndarray | None, size: int = 512, steps: int = 25,
            length: int = 150, seed: int = 42, pose_temp: np.ndarray | None = None,
            draw=None, pose_maps=None) -> np.ndarray:
    """The audio2video request on arrays: the audio models and the
    projection (``audio2vid.audio_case``, each frame drawn by ``draw`` or
    taken from ``pose_maps``), then the pipeline on the first ``length``
    frames at ``size x size``, CFG 3.5.  The audio phases go to the
    pipeline's timer beside its own.  Returns (L, size, size, 3) float32 in
    [0, 1]."""
    id_seed = None if pose_temp is not None else random.randint(0, 99)
    case = audio_case(models.a2m, models.a2p, sample, face_result, ref_rgb, ref_pose,
                      size, size, length, pose_temp, id_seed, draw=draw,
                      pose_maps=pose_maps, timer=models.pipe.timer)
    return models.pipe(ref_rgb, case["pose_images"], ref_pose, size, size,
                       case["kw"]["video_length"], steps, 3.5, seed=seed)


def run_audio2video(models: ServingModels, input_audio: str, ref_img_rgb: np.ndarray,
                    headpose_video: Optional[str] = None, size: int = 512,
                    steps: int = 25, length: int = 150, seed: int = 42,
                    out_dir: str = "output/serve"):
    """Audio-driven generation (reference app.py:146-270).  Returns
    (result mp4 path, cropped reference RGB), or (None, the input) when no
    face is found."""
    from aniportrait_tpu_torch.utils.audio_util import prepare_audio_feature

    prep = _prep_reference(ref_img_rgb, size)
    if prep is None:
        return None, ref_img_rgb
    ref_rgb, face_result, ref_pose, vis = prep
    sample = prepare_audio_feature(input_audio, fps=30)
    pose_temp = get_headpose_temp(headpose_video) if headpose_video is not None else None
    video = animate(models, sample, face_result, ref_rgb, ref_pose, size, steps, length,
                    seed, pose_temp,
                    draw=lambda v: vis.draw_landmarks((size, size), v, normed=False))
    return _write_result(video, out_dir, "a2v", input_audio), ref_rgb


def run_video2video(models: ServingModels, ref_img_rgb: np.ndarray, source_video: str,
                    size: int = 512, steps: int = 25, length: int = 150, seed: int = 42,
                    out_dir: str = "output/serve"):
    """Face reenactment (reference app.py:272-404)."""
    import cv2

    from aniportrait_tpu_torch.scripts.vid2vid import retarget_pose_and_expression
    from aniportrait_tpu_torch.utils.mp_utils import LMKExtractor
    from aniportrait_tpu_torch.utils.util import get_fps, read_frames

    prep = _prep_reference(ref_img_rgb, size)
    if prep is None:
        return None, ref_img_rgb
    ref_rgb, face_result, ref_pose, vis = prep
    lmk_extractor = LMKExtractor()

    frames = read_frames(source_video)
    fps = get_fps(source_video)
    step = 2 if fps == 60 else 1
    results = []
    shape = frames[0].shape[:2]
    for f in frames[::step][:length]:
        res = lmk_extractor(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        if res is None:
            break
        results.append(res)
    projected = retarget_pose_and_expression(results, face_result, list(shape))
    pose_images = [
        cv2.resize(vis.draw_landmarks((shape[1], shape[0]), v, normed=False), (size, size))
        for v in projected
    ]
    video = models.pipe(ref_rgb, pose_images, ref_pose, size, size, len(pose_images), steps,
                        3.5, seed=seed)
    return _write_result(video, out_dir, "v2v", source_video), ref_rgb
