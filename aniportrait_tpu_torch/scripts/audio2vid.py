"""Audio-driven generation CLI (port of ``scripts/audio2vid.py``).

    python -m aniportrait_tpu_torch.scripts.audio2vid --config ./configs/prompts/animation_audio.yaml -W 512 -H 512

Same flags and output as the JAX package's CLI: the prompt YAML's
``test_cases`` map reference images to audio files.  Per case the audio's
wav2vec2 features drive Audio2Mesh (vertex offsets added to the reference
face's neutral mesh) and the head pose comes from a template ``.npy``
(``pose_temp``: mirrored and tiled) or from Audio2Pose in 5-s chunks (last
chunk merged, rotation x0.5, smoothing window 7); the mesh is projected
through the reference's ``trans_mat``, drawn as the pose video, and
diffused; each case writes a 3-row (reference / pose / result) grid mp4,
with the audio muxed in where ffmpeg is present.  The models run on the
card unless ``--device cpu`` asks for the CPU.

The work splits as pose2vid's does: :func:`audio_case` (the audio models on
the device, then the projection) turns arrays (the audio feature, the
reference's face result, its image and pose drawing) into a ``run_cases``
case, drawing each frame with a ``draw`` callable or, where no drawing is
possible (the card's machine has no OpenCV), taking given ``pose_maps``;
``pose2vid.generate`` runs the cases.
"""

from __future__ import annotations

import argparse
import os
import random
from pathlib import Path

import numpy as np
import torch

from aniportrait_tpu_torch.config import load_config
from aniportrait_tpu_torch.scripts.loader import load_audio_models, sub_config
from aniportrait_tpu_torch.scripts.pose2vid import (
    ACC_NOT_PORTED,
    add_common_args,
    generate,
    load_pipe,
    output_dir,
    reference_pose,
)
from aniportrait_tpu_torch.utils.audio_util import prepare_audio_feature
from aniportrait_tpu_torch.utils.draw_util import FaceMeshVisualizer
from aniportrait_tpu_torch.utils.mp_utils import LMKExtractor
from aniportrait_tpu_torch.utils.pose_util import project_points, smooth_pose_seq
from aniportrait_tpu_torch.utils.profiling import PhaseTimer
from aniportrait_tpu_torch.utils.util import mux_audio, save_videos_grid

SAMPLE_RATE, FPS, CHUNK_SECONDS = 16000, 30, 5


def parse_args(argv=None):
    parser = add_common_args(argparse.ArgumentParser(),
                             "./configs/prompts/animation_audio.yaml", 30)
    parser.add_argument("--fi_weights", type=str, default=None,
                        help="FiLM net weights (with -acc, not ported yet)")
    return parser.parse_args(argv)


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def mesh_offsets(a2m, audio_feature: np.ndarray, seq_len: int) -> np.ndarray:
    """Audio2Mesh's per-frame vertex offsets, (seq_len, 468, 3)."""
    dev = _device(a2m)
    out = a2m(torch.from_numpy(np.asarray(audio_feature, np.float32))[None].to(dev), seq_len)
    return out[0].cpu().numpy().reshape(seq_len, -1, 3)


@torch.no_grad()
def generate_head_pose(a2p, audio_feature: np.ndarray, seq_len: int,
                       id_seed: int) -> np.ndarray:
    """Audio2Pose in 5-s chunks with the last chunk merged into the one
    before it (reference audio2vid.py:171-197): the equal chunks run as one
    batch, then the merged tail; rotation damped x0.5, smoothed over 7
    frames.  Returns (seq_len, 6).

    The last chunk gets the frames the others leave, ``seq_len - 150 * (n -
    1)``.  The reference (and the JAX package) gives it ``seq_len % 150``,
    which is 0 when the last chunk holds at least 4.967 s of audio: a 5.0-s
    clip then fails and a 10.0-s clip gets 150 poses for its 300 frames
    (ROADMAP F7).  Elsewhere the two counts are equal."""
    chunk_size, chunk_frames = SAMPLE_RATE * CHUNK_SECONDS, FPS * CHUNK_SECONDS
    audio = np.asarray(audio_feature, np.float32)
    chunks = [audio[i:i + chunk_size] for i in range(0, len(audio), chunk_size)]
    frames = [chunk_frames] * (len(chunks) - 1) + [seq_len - chunk_frames * (len(chunks) - 1)]
    if len(chunks) > 1:
        chunks[-2:] = [np.concatenate(chunks[-2:])]
        frames[-2:] = [frames[-2] + frames[-1]]
    dev = _device(a2p)

    def run(batch: np.ndarray, n: int):
        ids = torch.full((len(batch),), id_seed, dtype=torch.long, device=dev)
        return a2p(torch.from_numpy(batch).to(dev), n, ids).reshape(-1, 6)

    parts = []
    if len(chunks) > 1:  # the equal chunks in one batch, in order
        parts.append(run(np.stack(chunks[:-1]), frames[0]))
    parts.append(run(chunks[-1][None], frames[-1]))
    pose = torch.cat(parts).cpu().numpy()
    pose[:, :3] *= 0.5  # rotation damping (audio2vid.py:193)
    return smooth_pose_seq(pose, 7)


def template_head_pose(pose_temp: np.ndarray, seq_len: int) -> np.ndarray:
    """A head-pose template mirrored (there and back) and tiled to
    ``seq_len`` frames."""
    mirrored = np.concatenate((pose_temp, pose_temp[-2:0:-1]), axis=0)
    return np.tile(mirrored, (seq_len // len(mirrored) + 1, 1))[:seq_len]


def pose_vertices(a2m, a2p, audio_feature: np.ndarray, seq_len: int, face_result: dict,
                  width: int, height: int, pose_temp: np.ndarray | None = None,
                  id_seed: int | None = None, timer: PhaseTimer | None = None) -> np.ndarray:
    """The clip's projected mesh, (seq_len, 468, 2) pixels: Audio2Mesh's
    offsets on the reference's neutral mesh (``face_result["lmks3d"]``),
    posed by the template or by Audio2Pose, projected through its
    ``trans_mat``.  ``timer`` gets the phases ``audio2mesh`` and
    ``audio2pose``, each ending in a device synchronisation."""
    timer = timer or PhaseTimer()
    with timer.phase("audio2mesh"):
        pred = mesh_offsets(a2m, audio_feature, seq_len) + np.array(face_result["lmks3d"])
        _sync(_device(a2m))
    if pose_temp is not None:
        pose_seq = template_head_pose(pose_temp, seq_len)
    else:
        with timer.phase("audio2pose"):
            pose_seq = generate_head_pose(a2p, audio_feature, seq_len, id_seed)
            _sync(_device(a2p))
    return project_points(pred, np.array(face_result["trans_mat"]), pose_seq,
                          [height, width])


def audio_case(a2m, a2p, sample: dict, face_result: dict, ref_rgb: np.ndarray,
               ref_pose: np.ndarray | None, width: int, height: int,
               length: int | None = None, pose_temp: np.ndarray | None = None,
               id_seed: int | None = None, draw=None, pose_maps=None,
               timer: PhaseTimer | None = None) -> dict:
    """A ``run_cases`` case from arrays: ``sample`` is
    ``prepare_audio_feature``'s dict; the first ``length`` frames (default
    all) of :func:`pose_vertices`, each drawn by ``draw(vertices)`` as a
    ``width x height`` uint8 image, or, where no drawing is possible, the
    given ``pose_maps`` cycled to the clip in their place."""
    projected = pose_vertices(a2m, a2p, sample["audio_feature"], sample["seq_len"],
                              face_result, width, height, pose_temp, id_seed, timer)
    n = len(projected) if length is None else min(length, len(projected))
    if pose_maps is not None:
        poses = [pose_maps[i % len(pose_maps)] for i in range(n)]
    else:
        poses = [draw(verts) for verts in projected[:n]]
    return dict(ref_image=ref_rgb, pose_images=poses, ref_pose_image=ref_pose,
                kw=dict(video_length=n))


def main(argv=None):
    args = parse_args(argv)
    if args.accelerate:
        raise NotImplementedError(ACC_NOT_PORTED)
    import cv2

    config = load_config(args.config)
    a2m, a2p = load_audio_models(sub_config(config.audio_inference_config),
                                 device=args.device)
    pipe = load_pipe(config, args)
    save_dir, time_str = output_dir(args)
    lmk_extractor = LMKExtractor()
    vis = FaceMeshVisualizer(forehead_edge=False)
    pose_temp = np.load(str(config.pose_temp)) if config.get("pose_temp") else None

    def draw(verts):
        return vis.draw_landmarks((args.W, args.H), verts, normed=False)

    # host preparation (and the audio models) for every case first, so that
    # run_cases can overlap one case's IO with another's denoise
    cases, metas = [], []
    for ref_image_path, audio_paths in config["test_cases"].items():
        for audio_path in audio_paths:
            ref_rgb = cv2.cvtColor(cv2.imread(ref_image_path), cv2.COLOR_BGR2RGB)
            face_result, ref_pose = reference_pose(ref_rgb, args, lmk_extractor, vis)
            sample = prepare_audio_feature(audio_path, fps=args.fps)
            id_seed = None if pose_temp is not None else random.randint(0, 99)
            cases.append(audio_case(a2m, a2p, sample, face_result, ref_rgb, ref_pose,
                                    args.W, args.H, args.L, pose_temp, id_seed, draw=draw))
            metas.append(dict(ref_name=Path(ref_image_path).stem,
                              audio_name=Path(audio_path).stem, audio_path=audio_path))

    for key, grid in generate(pipe, cases, args):
        meta = metas[key]
        noaudio = (f"{save_dir}/{meta['ref_name']}_{meta['audio_name']}"
                   f"_{args.H}x{args.W}_{int(args.cfg)}_{time_str}_noaudio.mp4")
        save_videos_grid(grid, noaudio, fps=args.fps)
        final = noaudio.replace("_noaudio.mp4", ".mp4")
        if mux_audio(noaudio, meta["audio_path"], final):
            os.remove(noaudio)
            print(f"saved {final}")
        else:
            print(f"saved {noaudio} (no ffmpeg for audio mux)")


if __name__ == "__main__":
    main()
