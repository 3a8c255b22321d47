"""Full face-landmarker pipeline on TFLite interpreters (no mediapipe).

The port's copy of ``aniportrait_tpu/landmark/pipeline.py`` (held to it by
``tests/test_torch_copies.py``).

Native-equivalent of the MediaPipe FaceLandmarker graph the reference vendors
(reference src/utils/face_landmark.py + mp_models/*, SURVEY §2.1):
BlazeFace short-range detection -> rotated face ROI -> 478-point attention
mesh -> blendshapes -> face-geometry solve.  Runs the exact model files the
reference ships; the graph logic (anchors, decode, NMS, ROI math, projection)
is reimplemented here, and the geometry solver lives in
``aniportrait_tpu_torch.landmark.geometry``.

Interpreters default to ``tf.lite`` (XNNPACK) when tensorflow is importable;
the in-repo C++ runner (``native/tflite_runner/``) slots in behind the same
``InterpreterLike`` duck type via ``engine='native'`` and is the fallback in
TF-less environments.

Output matches reference ``mp_utils.LMKExtractor.__call__`` (mp_utils.py:63-91):
``{lmks (478,3), lmks3d (468,3), trans_mat (4,4), faces, bs (51)}``.
"""

from __future__ import annotations

import math
import os
import zipfile
from typing import Optional

import numpy as np

from aniportrait_tpu_torch.landmark.anchors import blazeface_short_range_anchors
from aniportrait_tpu_torch.landmark.blazeface import decode_detections, weighted_nms
from aniportrait_tpu_torch.landmark.geometry import (
    GeometrySolver,
    load_geometry_metadata,
    parse_message,
)

DEFAULT_TASK = os.path.join(
    os.path.dirname(__file__), "..", "..", "third_party", "mp_models",
    "face_landmarker_v2_with_blendshapes.task",
)

# MediaPipe face_blendshapes_graph landmark subset (146 points: contours +
# irises), as embedded in ``face_blendshapes.tflite`` itself — the model
# carries the exact index tensor it was trained with; parsed at load time by
# :func:`blendshape_subset_from_task` (this constant is the verified parse of
# the reference's shipped bundle, kept as fallback).  Blendshape scores are
# used downstream to pick the most-neutral frame (reference vid2vid.py:174-177).
BLENDSHAPE_SUBSET = [
    0, 1, 4, 5, 6, 7, 8, 10, 13, 14, 17, 21, 33, 37, 39, 40, 46, 52, 53, 54,
    55, 58, 61, 63, 65, 66, 67, 70, 78, 80, 81, 82, 84, 87, 88, 91, 93, 95,
    103, 105, 107, 109, 127, 132, 133, 136, 144, 145, 146, 148, 149, 150,
    152, 153, 154, 155, 157, 158, 159, 160, 161, 162, 163, 168, 172, 173,
    176, 178, 181, 185, 191, 195, 197, 234, 246, 249, 251, 263, 267, 269,
    270, 276, 282, 283, 284, 285, 288, 291, 293, 295, 296, 297, 300, 308,
    310, 311, 312, 314, 317, 318, 321, 323, 324, 332, 334, 336, 338, 356,
    361, 362, 365, 373, 374, 375, 377, 378, 379, 380, 381, 382, 384, 385,
    386, 387, 388, 389, 390, 397, 398, 400, 402, 405, 409, 415, 454, 466,
    468, 469, 470, 471, 472, 473, 474, 475, 476, 477,
]


def blendshape_subset_from_task(blendshapes_tflite: bytes) -> list:
    """Extract the 146-landmark selection tensor from the blendshapes model.

    The converted model embeds the exact landmark-index tensor the blendshape
    head was trained on.  Rather than hardcoding a reconstruction of the
    MediaPipe graph constant, scan the flatbuffer for the unique aligned
    int32 run of >=100 strictly-increasing values inside [0, 478) — on the
    reference's shipped bundle exactly one such run exists (length 146).
    Falls back to :data:`BLENDSHAPE_SUBSET` if the scan is ambiguous.
    """
    arr = np.frombuffer(
        blendshapes_tflite[: len(blendshapes_tflite) // 4 * 4], "<i4"
    )
    runs = []
    i, n = 0, len(arr)
    while i < n - 1:
        if 0 <= arr[i] < 478 and arr[i] < arr[i + 1] < 478:
            j = i + 1
            while j < n - 1 and arr[j] < arr[j + 1] < 478:
                j += 1
            if j - i + 1 >= 100:
                runs.append(arr[i : j + 1])
            i = j + 1
        else:
            i += 1
    if len(runs) == 1:
        return [int(v) for v in runs[0]]
    return list(BLENDSHAPE_SUBSET)


class _TFLiteWrapper:
    def __init__(self, model_content: bytes):
        import tensorflow as tf

        self.it = tf.lite.Interpreter(model_content=model_content)
        self.it.allocate_tensors()

    def run(self, inputs: np.ndarray):
        d = self.it.get_input_details()[0]
        self.it.set_tensor(d["index"], inputs)
        self.it.invoke()
        return [self.it.get_tensor(o["index"]) for o in self.it.get_output_details()]


def _make_interpreter(model_content: bytes, engine: str):
    if engine == "native":
        from aniportrait_tpu_torch.landmark.native import NativeInterpreter

        return NativeInterpreter(model_content)
    return _TFLiteWrapper(model_content)


def _run(it, inputs: np.ndarray):
    return it.run(inputs)


class FaceLandmarkerLite:
    """engine: 'tflite' (XNNPACK via tf.lite, fastest) or 'native' (the
    in-repo C++ interpreter, native/tflite_runner/)."""

    def __init__(
        self,
        task_path: Optional[str] = None,
        min_detection_score: float = 0.5,
        engine: str = "tflite",
    ):
        task_path = task_path or os.path.abspath(DEFAULT_TASK)
        with zipfile.ZipFile(task_path) as z:
            det_bytes = z.read("face_detector.tflite")
            lmk_bytes = z.read("face_landmarks_detector.tflite")
            bs_bytes = z.read("face_blendshapes.tflite")
        self.det = _make_interpreter(det_bytes, engine)
        self.lmk = _make_interpreter(lmk_bytes, engine)
        self.bs = _make_interpreter(bs_bytes, engine)
        self.blendshape_subset = blendshape_subset_from_task(bs_bytes)
        self.anchors = blazeface_short_range_anchors()
        self.meta = load_geometry_metadata(task_path)
        self.solver = GeometrySolver(self.meta)
        self.min_detection_score = min_detection_score
        self.faces = None
        # triangle indices (+1, reference mp_utils.py:83)
        with zipfile.ZipFile(task_path) as z:
            raw = z.read("geometry_pipeline_metadata_landmarks.binarypb")
        from aniportrait_tpu_torch.landmark.geometry import _uints

        mesh_msg = parse_message(parse_message(raw)[1][0])
        if 4 in mesh_msg:
            idx = _uints(mesh_msg[4])
            self.faces = idx.reshape(-1, 3).astype(np.int64) + 1

    # ------------------------------------------------------------ detection
    def _detect_face(self, rgb: np.ndarray):
        import cv2

        H, W = rgb.shape[:2]
        size = max(H, W)
        # symmetric letterbox to square, then resize to 128
        pad_y, pad_x = (size - H) // 2, (size - W) // 2
        sq = np.zeros((size, size, 3), rgb.dtype)
        sq[pad_y : pad_y + H, pad_x : pad_x + W] = rgb
        inp = cv2.resize(sq, (128, 128)).astype(np.float32) / 127.5 - 1.0

        regressors, scores = _run(self.det, inp[None])
        dets = decode_detections(
            np.asarray(regressors).reshape(896, 16),
            np.asarray(scores).reshape(896, 1),
            self.anchors,
            min_score=self.min_detection_score,
        )
        dets = weighted_nms(dets)
        if len(dets) == 0:
            return None
        d = dets[0].copy()
        # unletterbox: square-normalised -> image-normalised
        d[1::2] = (d[1::2] * size - pad_x) / W  # xs
        d[2::2] = (d[2::2] * size - pad_y) / H  # ys
        return d

    # ------------------------------------------------------------ landmarks
    def _roi_from_detection(self, det: np.ndarray, W: int, H: int):
        """MediaPipe detection->rect: rotation from the eye keypoints
        (target angle 0), bbox rect, scale 1.5, square on the long side."""
        x_min, y_min, x_max, y_max = det[1:5]
        kp = det[5:17].reshape(6, 2)
        x0, y0 = kp[0]  # right eye
        x1, y1 = kp[1]  # left eye
        rotation = -math.atan2(-(y1 - y0) * H, (x1 - x0) * W)

        cx, cy = (x_min + x_max) / 2 * W, (y_min + y_max) / 2 * H
        w, h = (x_max - x_min) * W, (y_max - y_min) * H
        side = max(w, h) * 1.5
        return cx, cy, side, rotation

    def _crop(self, rgb: np.ndarray, cx, cy, side, rotation, out_size=256):
        import cv2

        cos, sin = math.cos(rotation), math.sin(rotation)
        s = side / out_size
        # map output pixel (u, v) -> image coords
        M = np.array(
            [
                [cos * s, -sin * s, cx - (cos * s * out_size / 2 - sin * s * out_size / 2)],
                [sin * s, cos * s, cy - (sin * s * out_size / 2 + cos * s * out_size / 2)],
            ],
            np.float32,
        )
        crop = cv2.warpAffine(
            rgb, M, (out_size, out_size),
            flags=cv2.WARP_INVERSE_MAP | cv2.INTER_LINEAR,
        )
        return crop, M

    def __call__(self, img_bgr: np.ndarray):
        import cv2

        rgb = cv2.cvtColor(img_bgr, cv2.COLOR_BGR2RGB)
        H, W = rgb.shape[:2]
        det = self._detect_face(rgb)
        if det is None:
            return None
        cx, cy, side, rotation = self._roi_from_detection(det, W, H)

        crop, M = self._crop(rgb, cx, cy, side, rotation)
        inp = crop.astype(np.float32) / 255.0
        outs = _run(self.lmk, inp[None])
        raw_lm = np.asarray(outs[0]).reshape(478, 3) / 256.0  # crop-normalised
        flag = float(np.asarray(outs[1]).reshape(-1)[0])
        if flag < 0 or flag > 1:
            flag = 1.0 / (1.0 + math.exp(-flag))
        if flag < 0.5:
            return None

        # project crop-space landmarks back to image-normalised coords
        cos, sin = math.cos(rotation), math.sin(rotation)
        dx = (raw_lm[:, 0] - 0.5) * side
        dy = (raw_lm[:, 1] - 0.5) * side
        x_img = (cx + cos * dx - sin * dy) / W
        y_img = (cy + sin * dx + cos * dy) / H
        z_img = raw_lm[:, 2] * side / W
        lmks = np.stack([x_img, y_img, z_img], axis=1)

        # blendshapes from the 146-point subset (normalised coords)
        subset = lmks[self.blendshape_subset, :2].astype(np.float32)
        bs_scores = np.asarray(_run(self.bs, subset[None])[0]).reshape(-1)
        bs_values = bs_scores[1:].tolist()  # drop neutral (mp_utils.py:69)

        geo = self.solver.solve(lmks, (W, H))
        return {
            "lmks": lmks.astype(np.float32),
            "lmks3d": geo["mesh"],
            "trans_mat": geo["trans_mat"],
            "faces": self.faces,
            "bs": bs_values,
        }
