"""Training-data extractor (the port's copy of the JAX package's
``scripts/preprocess_dataset.py``, after the reference's): for every
``*.png`` frame of every folder under ``--input_dir``, the landmarks saved as
``<frame>_lmks.npy``, ``_lmks3d.npy``, ``_trans_mat.npy`` and ``_bs.npy``
under ``--output_dir/<folder>``, then the manifest JSON that
``train/dataset.py`` reads (clips of at least 30 frames).  Host only
(OpenCV):

    python -m aniportrait_tpu_torch.scripts.preprocess_dataset \
        --input_dir frames/ --output_dir face_info/ --training_json train.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def generate_training_json_mesh(video_dir, face_info_dir, res_json_path, min_clip_length=30):
    video_name_list = sorted(os.listdir(face_info_dir))
    res_data_dic = {}

    for video_name in video_name_list:
        video_clip_dir = os.path.join(video_dir, video_name)
        lmks_clip_dir = os.path.join(face_info_dir, video_name)

        frame_path_list = sorted(glob.glob(os.path.join(video_clip_dir, "*.png")))
        lmks_path_list = sorted(glob.glob(os.path.join(lmks_clip_dir, "*lmks.npy")))
        min_len = min(len(frame_path_list), len(lmks_path_list))
        frame_path_list = frame_path_list[:min_len]
        lmks_path_list = lmks_path_list[:min_len]

        if min_len < min_clip_length:
            continue

        first_frame = os.path.basename(frame_path_list[0]).split(".")[0]
        first_lmks = os.path.basename(lmks_path_list[0]).split("_")[0]
        last_frame = os.path.basename(frame_path_list[-1]).split(".")[0]
        last_lmks = os.path.basename(lmks_path_list[-1]).split("_")[0]
        if first_frame != first_lmks or last_frame != last_lmks:
            continue

        res_data_dic[video_name] = {
            "video_clip_num": 1,
            "clip_data_list": [
                {
                    "frame_name_list": [
                        os.path.join(video_name, os.path.basename(p))
                        for p in frame_path_list
                    ],
                    "frame_path_list": frame_path_list,
                    "lmks_list": lmks_path_list,
                }
            ],
        }

    with open(res_json_path, "w") as f:
        json.dump(res_data_dic, f)


def main(argv=None):
    import cv2

    from aniportrait_tpu_torch.utils.mp_utils import LMKExtractor

    parser = argparse.ArgumentParser()
    parser.add_argument("--input_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--training_json", type=str, required=True)
    args = parser.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    folders = sorted(f.path for f in os.scandir(args.input_dir) if f.is_dir())
    lmk_extractor = LMKExtractor()

    for folder in folders:
        output_subdir = os.path.join(args.output_dir, os.path.basename(folder))
        os.makedirs(output_subdir, exist_ok=True)
        for img_file in sorted(glob.glob(os.path.join(folder, "*.png"))):
            base = os.path.splitext(os.path.basename(img_file))[0]
            img = cv2.imread(img_file)
            result = lmk_extractor(img)
            if result is None:
                continue
            np.save(os.path.join(output_subdir, base + "_lmks.npy"),
                    np.array(result["lmks"]).astype(np.float32))
            np.save(os.path.join(output_subdir, base + "_lmks3d.npy"),
                    np.array(result["lmks3d"]).astype(np.float32))
            np.save(os.path.join(output_subdir, base + "_trans_mat.npy"),
                    np.array(result["trans_mat"]).astype(np.float32))
            np.save(os.path.join(output_subdir, base + "_bs.npy"),
                    np.array(result["bs"]).astype(np.float32))

    generate_training_json_mesh(
        args.input_dir, args.output_dir, args.training_json, min_clip_length=30
    )


if __name__ == "__main__":
    main()
