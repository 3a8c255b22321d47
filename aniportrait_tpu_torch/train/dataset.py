"""Training dataset over the preprocessed-video JSON manifest (the port's
copy of ``aniportrait_tpu/train/dataset.py``; held to it batch for batch by
``tests/test_torch_copies.py``).  It decodes and resizes with OpenCV, so it
runs where OpenCV is installed; the trainer takes any iterator of batches.

Parity target: reference ``src/dataset/dataset_face.py`` (FaceDataset):
manifest maps video -> clip_data_list -> {frame_path_list, lmks_list};
sampling picks a random clip, random stride window (stage 1: single frame;
stage 2: 16 frames via linspace, stride 4 or stride-aug), a random reference
frame from the same video, re-renders pose images from saved normalised
landmarks, CLIP-preprocesses the reference, and normalises images to [-1,1].

Outputs channels-last numpy batches in the ``train.train_step`` contract.
``clip_size``: the CLIP image side (224 for ViT-L/14; the small test models
take less).
"""

from __future__ import annotations

import json
import random
from typing import Dict, Iterator, List, Optional

import numpy as np

from aniportrait_tpu_torch.models.clip_vision import CLIP_MEAN, CLIP_STD
from aniportrait_tpu_torch.utils.draw_util import FaceMeshVisualizer


def prepare_clip_image(img: np.ndarray, size: int = 224) -> np.ndarray:
    """uint8 RGB -> CLIP-normalised float32 (size, size, 3): OpenCV's
    bicubic resize straight to the square, as
    ``aniportrait_tpu/utils/image.py:prepare_clip_image`` does."""
    import cv2

    if img.shape[:2] != (size, size):
        img = cv2.resize(img, (size, size), interpolation=cv2.INTER_CUBIC)
    x = img.astype(np.float32) / 255.0
    return (x - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32)


class FaceDataset:
    def __init__(
        self,
        json_path: str,
        extra_json_path: Optional[str] = None,
        sample_size=(512, 512),
        sample_stride: int = 4,
        sample_n_frames: int = 16,
        is_image: bool = False,
        sample_stride_aug: bool = False,
        seed: Optional[int] = None,
        clip_size: int = 224,
    ):
        with open(json_path) as f:
            self.data_dic = json.load(f)
        self.names: List[str] = [
            n for n in self.data_dic if len(self.data_dic[n]["clip_data_list"]) >= 1
        ]
        if extra_json_path is not None:
            with open(extra_json_path) as f:
                extra = json.load(f)
            self.data_dic.update(extra)
            # extra data is oversampled 3x (dataset_face.py:222-227)
            self.names.extend([n for n in extra for _ in range(3)])
        self.rng = random.Random(seed)
        self.rng.shuffle(self.names)

        self.sample_size = tuple(sample_size)
        self.sample_stride = sample_stride
        self.sample_n_frames = sample_n_frames
        self.is_image = is_image
        self.sample_stride_aug = sample_stride_aug
        self.clip_size = clip_size
        self.visualizer = FaceMeshVisualizer(forehead_edge=False)

    def __len__(self):
        return len(self.names)

    def shard(self, process_index: int, process_count: int) -> None:
        """Multi-host data parallelism: keep every process_count-th video
        (after the seeded shuffle, so shards are disjoint and balanced).
        The reference's analog is DistributedSampler inside Accelerate's
        dataloader prepare (train_stage_1.py:410-421)."""
        self.names = self.names[process_index::process_count]

    def _load_rgb(self, path: str) -> np.ndarray:
        import cv2

        img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        if img.shape[:2] != (self.sample_size[1], self.sample_size[0]):
            img = cv2.resize(img, self.sample_size)
        return img

    def _norm(self, img: np.ndarray) -> np.ndarray:
        return img.astype(np.float32) / 255.0 * 2.0 - 1.0

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = self.rng
        video_name = self.names[index % len(self.names)]
        clips = self.data_dic[video_name]["clip_data_list"]
        clip = clips[rng.randrange(len(clips))]
        frame_paths = clip["frame_path_list"]
        lmk_paths = clip["lmks_list"]
        video_length = len(frame_paths)

        if self.sample_stride_aug:
            stride = self.sample_stride if rng.random() > 0.5 else 4
        else:
            stride = self.sample_stride

        if self.is_image:
            batch_index = [rng.randint(0, video_length - 1)]
        else:
            clip_length = min(video_length, (self.sample_n_frames - 1) * stride + 1)
            start_idx = rng.randint(0, video_length - clip_length)
            batch_index = np.linspace(
                start_idx, start_idx + clip_length - 1, self.sample_n_frames, dtype=int
            ).tolist()

        ref_idx = rng.randint(0, video_length - 1)
        ref_img = self._load_rgb(frame_paths[ref_idx])
        clip_ref = prepare_clip_image(ref_img, self.clip_size)

        frames = np.stack([self._norm(self._load_rgb(frame_paths[i])) for i in batch_index])
        pose_frames = np.stack(
            [
                self._norm(
                    self.visualizer.draw_landmarks(
                        self.sample_size, np.load(lmk_paths[i]).astype(float), normed=True
                    )
                )
                for i in batch_index
            ]
        )

        return {
            "pixel_values": frames,  # (f, H, W, 3) in [-1,1]
            "pixel_values_pose": pose_frames,
            "pixel_values_ref_img": self._norm(ref_img),
            "clip_ref_image": clip_ref,
        }

    def validation_sample(self, index: int) -> Dict[str, np.ndarray]:
        """Raw uint8 sample for validation-time pipeline sampling
        (reference FaceDatasetValid, dataset_face.py:22-166): reference
        image, target frames, and re-rendered pose images, un-normalised."""
        rng = self.rng
        video_name = self.names[index % len(self.names)]
        clips = self.data_dic[video_name]["clip_data_list"]
        clip = clips[rng.randrange(len(clips))]
        frame_paths = clip["frame_path_list"]
        lmk_paths = clip["lmks_list"]
        video_length = len(frame_paths)

        if self.is_image:
            batch_index = [rng.randint(0, video_length - 1)]
        else:
            clip_length = min(
                video_length, (self.sample_n_frames - 1) * self.sample_stride + 1
            )
            start_idx = rng.randint(0, video_length - clip_length)
            batch_index = np.linspace(
                start_idx, start_idx + clip_length - 1, self.sample_n_frames, dtype=int
            ).tolist()
        ref_idx = rng.randint(0, video_length - 1)
        return {
            "ref_image": self._load_rgb(frame_paths[ref_idx]),
            "frames": np.stack([self._load_rgb(frame_paths[i]) for i in batch_index]),
            "pose_images": np.stack(
                [
                    self.visualizer.draw_landmarks(
                        self.sample_size, np.load(lmk_paths[i]).astype(float),
                        normed=True,
                    )
                    for i in batch_index
                ]
            ),
        }

    def batches(self, batch_size: int, epochs: Optional[int] = None) -> Iterator[Dict]:
        """Simple host-side batch iterator (the reference uses a 4-worker
        torch DataLoader; single-host numpy loading here, run ahead by
        ``train/prefetch.py``)."""
        if len(self) < batch_size:  # no epoch would yield a batch
            raise ValueError(f"{len(self)} videos for batches of {batch_size}")
        epoch = 0
        while epochs is None or epoch < epochs:
            order = list(range(len(self)))
            self.rng.shuffle(order)
            for i in range(0, len(order) - batch_size + 1, batch_size):
                samples = [self[j] for j in order[i : i + batch_size]]
                yield {
                    k: np.stack([s[k] for s in samples]) for k in samples[0]
                }
            epoch += 1
