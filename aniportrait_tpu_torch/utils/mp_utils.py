"""Face landmark extraction front-end.

The port's copy of ``aniportrait_tpu/utils/mp_utils.py`` (held to it by
``tests/test_torch_copies.py``).

Parity target: reference ``src/utils/mp_utils.py`` (``LMKExtractor``) — per
image returns ``{bs (52 blendshapes), lmks (478x3 normalised), lmks3d
(canonical-space mesh verts), trans_mat (4x4 head pose), faces}`` via a
modified MediaPipe FaceLandmarker that also surfaces the face-geometry mesh
vertex buffer (reference face_landmark.py:2989-2993, 3173-3212).

This build uses a pluggable backend:
  * ``mediapipe`` — when the mediapipe package is importable, drive the same
    two models the reference ships (third_party/mp_models/*); ``lmks3d`` is
    computed by the in-repo geometry solver (the tasks API does not expose
    the mesh vertex buffer the reference patches in).
  * ``tflite`` — the in-repo landmark graph (``aniportrait_tpu_torch.landmark``)
    on tf.lite/XNNPACK interpreters.
  * ``native`` — the same graph on the in-repo C++ TFLite interpreter
    (``native/tflite_runner/``, built on demand); works with no mediapipe
    and no tensorflow installed.
  * ``precomputed`` — serve landmarks from .npz/.npy sidecar files
    (the training pipeline's format, preprocess_dataset.py:78-109); also the
    deterministic test backend.

``auto`` resolves mediapipe -> tflite -> native.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


class PrecomputedBackend:
    """Looks up <frame_key>.npz with arrays lmks/lmks3d/trans_mat/bs."""

    def __init__(self, root: str):
        self.root = root
        self._idx = 0

    def detect(self, image: np.ndarray, key: Optional[str] = None):
        if key is None:
            key = str(self._idx)
            self._idx += 1
        path = os.path.join(self.root, f"{key}.npz")
        if not os.path.exists(path):
            return None
        data = np.load(path)
        return {
            "lmks": data["lmks"],
            "lmks3d": data.get("lmks3d"),
            "trans_mat": data.get("trans_mat"),
            "bs": data.get("bs"),
            "faces": data.get("faces"),
        }


class MediaPipeBackend:
    """Wraps the mediapipe tasks FaceLandmarker (when available) with
    facial_transformation_matrixes + blendshapes enabled.  The public tasks
    API does not expose the face-geometry mesh vertex buffer the reference
    patches in (reference face_landmark.py:2989-2993), so ``lmks3d`` +
    ``trans_mat`` are computed by the in-repo weighted-Procrustes geometry
    solver from the screen landmarks — the same math MediaPipe's C++
    FaceGeometryFromLandmarks graph runs internally."""

    def __init__(self, task_path: Optional[str] = None):
        import mediapipe as mp
        from mediapipe.tasks import python as mp_python
        from mediapipe.tasks.python import vision

        from aniportrait_tpu_torch.landmark.geometry import (
            GeometrySolver,
            load_geometry_metadata,
        )
        from aniportrait_tpu_torch.landmark.pipeline import DEFAULT_TASK

        task_path = task_path or os.path.abspath(DEFAULT_TASK)
        self.solver = GeometrySolver(load_geometry_metadata(task_path))
        base_options = mp_python.BaseOptions(model_asset_path=task_path)
        options = vision.FaceLandmarkerOptions(
            base_options=base_options,
            output_face_blendshapes=True,
            output_facial_transformation_matrixes=True,
            num_faces=1,
            min_face_detection_confidence=0.5,
        )
        self.landmarker = vision.FaceLandmarker.create_from_options(options)
        self.mp = mp

    def detect(self, image_bgr: np.ndarray, key=None):
        import cv2

        rgb = cv2.cvtColor(image_bgr, cv2.COLOR_BGR2RGB)
        mp_img = self.mp.Image(image_format=self.mp.ImageFormat.SRGB, data=rgb)
        res = self.landmarker.detect(mp_img)
        if not res.face_landmarks:
            return None
        lmks = np.array(
            [[l.x, l.y, l.z] for l in res.face_landmarks[0]], dtype=np.float32
        )
        trans_mat = np.array(res.facial_transformation_matrixes[0], dtype=np.float32)
        bs = np.array(
            [b.score for b in res.face_blendshapes[0]], dtype=np.float32
        )
        # exact canonical-space mesh via the in-repo geometry solver (the
        # tasks API does not surface the mesh buffer; see class docstring)
        h, w = image_bgr.shape[:2]
        geo = self.solver.solve(lmks, (w, h))
        return {
            "lmks": lmks,
            "lmks3d": geo["mesh"],
            "trans_mat": trans_mat,
            "bs": bs,
            "faces": None,
        }


class _CallableBackend:
    """Adapts a plain callable (e.g. FaceLandmarkerLite) to the backend API."""

    def __init__(self, fn):
        self.fn = fn

    def detect(self, image_bgr, key=None):
        return self.fn(image_bgr)


class LMKExtractor:
    """Reference-compatible callable (mp_utils.py:19-94)."""

    def __init__(self, backend: str = "auto", **kwargs):
        if backend == "auto":
            try:
                import mediapipe  # noqa: F401

                backend = "mediapipe"
            except ImportError:
                try:
                    import tensorflow  # noqa: F401

                    backend = "tflite"
                except ImportError:
                    # in-repo C++ interpreter: no mediapipe, no tensorflow
                    backend = "native"
        if backend in ("tflite", "native"):
            from aniportrait_tpu_torch.landmark import FaceLandmarkerLite

            kwargs.setdefault("engine", backend)
            self.backend = _CallableBackend(FaceLandmarkerLite(**kwargs))
        elif backend == "mediapipe":
            self.backend = MediaPipeBackend(**kwargs)
        elif backend == "precomputed":
            self.backend = PrecomputedBackend(**kwargs)
        elif backend == "unavailable":
            self.backend = None
        else:
            raise ValueError(f"unknown landmark backend: {backend}")

    def __call__(self, image_bgr: np.ndarray, key=None) -> Optional[Dict]:
        if self.backend is None:
            raise RuntimeError(
                "No landmark backend available: install mediapipe, use "
                "backend='precomputed' with sidecar files, or build the "
                "native TFLite runner."
            )
        return self.backend.detect(image_bgr, key)
