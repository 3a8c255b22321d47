"""Pose-image rasterisation (cv2, host-side) — the conditioning signal.

The port's copy of ``aniportrait_tpu/utils/draw_util.py`` (held to it by
``tests/test_torch_copies.py``).

Parity target: reference ``src/utils/draw_util.py``: face landmarks rendered
as fixed color-coded edges (custom face oval, eyes, brows, 8 lip segments,
2 px lines) on a 512x512 black canvas, then resized to the target size.  The
exact colors/edges are part of the learned conditioning contract, so the
edge tables below reproduce the reference's spec (draw_util.py:16-91),
including the MediaPipe FACEMESH_* constants it pulls in (public topology
constants of the 468-point face mesh).

Line drawing matches mediapipe.solutions.drawing_utils.draw_landmarks:
a landmark is valid iff 0 <= x,y <= 1; pixel = min(floor(v * size), size-1);
an edge is drawn iff both endpoints are valid; cv2.line thickness 2.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

# --- MediaPipe face-mesh topology (public constants) ----------------------
FACEMESH_LEFT_EYE = [
    (263, 249), (249, 390), (390, 373), (373, 374), (374, 380), (380, 381),
    (381, 382), (382, 362), (263, 466), (466, 388), (388, 387), (387, 386),
    (386, 385), (385, 384), (384, 398), (398, 362),
]
FACEMESH_LEFT_EYEBROW = [
    (276, 283), (283, 282), (282, 295), (295, 285), (300, 293), (293, 334),
    (334, 296), (296, 336),
]
FACEMESH_RIGHT_EYE = [
    (33, 7), (7, 163), (163, 144), (144, 145), (145, 153), (153, 154),
    (154, 155), (155, 133), (33, 246), (246, 161), (161, 160), (160, 159),
    (159, 158), (158, 157), (157, 173), (173, 133),
]
FACEMESH_RIGHT_EYEBROW = [
    (46, 53), (53, 52), (52, 65), (65, 55), (70, 63), (63, 105), (105, 66),
    (66, 107),
]
FACEMESH_FACE_OVAL = [
    (10, 338), (338, 297), (297, 332), (332, 284), (284, 251), (251, 389),
    (389, 356), (356, 454), (454, 323), (323, 361), (361, 288), (288, 397),
    (397, 365), (365, 379), (379, 378), (378, 400), (400, 377), (377, 152),
    (152, 148), (148, 176), (176, 149), (149, 150), (150, 136), (136, 172),
    (172, 58), (58, 132), (132, 93), (93, 234), (234, 127), (127, 162),
    (162, 21), (21, 54), (54, 103), (103, 67), (67, 109), (109, 10),
]

# --- reference's custom edge groups (draw_util.py:36-48) ------------------
FACEMESH_LIPS_OUTER_BOTTOM_LEFT = [(61, 146), (146, 91), (91, 181), (181, 84), (84, 17)]
FACEMESH_LIPS_OUTER_BOTTOM_RIGHT = [(17, 314), (314, 405), (405, 321), (321, 375), (375, 291)]
FACEMESH_LIPS_INNER_BOTTOM_LEFT = [(78, 95), (95, 88), (88, 178), (178, 87), (87, 14)]
FACEMESH_LIPS_INNER_BOTTOM_RIGHT = [(14, 317), (317, 402), (402, 318), (318, 324), (324, 308)]
FACEMESH_LIPS_OUTER_TOP_LEFT = [(61, 185), (185, 40), (40, 39), (39, 37), (37, 0)]
FACEMESH_LIPS_OUTER_TOP_RIGHT = [(0, 267), (267, 269), (269, 270), (270, 409), (409, 291)]
FACEMESH_LIPS_INNER_TOP_LEFT = [(78, 191), (191, 80), (80, 81), (81, 82), (82, 13)]
FACEMESH_LIPS_INNER_TOP_RIGHT = [(13, 312), (312, 311), (311, 310), (310, 415), (415, 308)]
FACEMESH_CUSTOM_FACE_OVAL = [
    (176, 149), (150, 136), (356, 454), (58, 132), (152, 148), (361, 288),
    (251, 389), (132, 93), (389, 356), (400, 377), (136, 172), (377, 152),
    (323, 361), (172, 58), (454, 323), (365, 379), (379, 378), (148, 176),
    (93, 234), (397, 365), (149, 150), (288, 397), (234, 127), (378, 400),
    (127, 162), (162, 21),
]


class FaceMeshVisualizer:
    """Reference color/edge spec (draw_util.py:13-93), thickness 2."""

    def __init__(self, forehead_edge: bool = False):
        self.thickness = 2
        right_eye = (10, 200, 180)
        right_eyebrow = (10, 220, 180)
        left_eye = (180, 200, 10)
        left_eyebrow = (180, 220, 10)
        head = (10, 200, 10)
        mouth_obl = (10, 180, 20)
        mouth_obr = (20, 10, 180)
        mouth_ibl = (100, 100, 30)
        mouth_ibr = (100, 150, 50)
        mouth_otl = (20, 80, 100)
        mouth_otr = (80, 100, 20)
        mouth_itl = (120, 100, 200)
        mouth_itr = (150, 120, 100)

        spec: Dict[Tuple[int, int], Tuple[int, int, int]] = {}
        oval = FACEMESH_FACE_OVAL if forehead_edge else FACEMESH_CUSTOM_FACE_OVAL
        for edge in oval:
            spec[edge] = head
        for edge in FACEMESH_LEFT_EYE:
            spec[edge] = left_eye
        for edge in FACEMESH_LEFT_EYEBROW:
            spec[edge] = left_eyebrow
        for edge in FACEMESH_RIGHT_EYE:
            spec[edge] = right_eye
        for edge in FACEMESH_RIGHT_EYEBROW:
            spec[edge] = right_eyebrow
        for edge, color in [
            *[(e, mouth_obl) for e in FACEMESH_LIPS_OUTER_BOTTOM_LEFT],
            *[(e, mouth_obr) for e in FACEMESH_LIPS_OUTER_BOTTOM_RIGHT],
            *[(e, mouth_ibl) for e in FACEMESH_LIPS_INNER_BOTTOM_LEFT],
            *[(e, mouth_ibr) for e in FACEMESH_LIPS_INNER_BOTTOM_RIGHT],
            *[(e, mouth_otl) for e in FACEMESH_LIPS_OUTER_TOP_LEFT],
            *[(e, mouth_otr) for e in FACEMESH_LIPS_OUTER_TOP_RIGHT],
            *[(e, mouth_itl) for e in FACEMESH_LIPS_INNER_TOP_LEFT],
            *[(e, mouth_itr) for e in FACEMESH_LIPS_INNER_TOP_RIGHT],
        ]:
            spec[edge] = color
        self.face_connection_spec = spec

    @staticmethod
    def _pixel(v: float, size: int):
        """mediapipe drawing_utils normalised->pixel conversion."""
        ok = (v > 0 or math.isclose(0, v)) and (v < 1 or math.isclose(1, v))
        if not ok:
            return None
        return min(math.floor(v * size), size - 1)

    def draw_landmarks(self, image_size, keypoints: np.ndarray, normed: bool = False):
        """keypoints: (478 or 468, 2+) landmark coords (pixels, or [0,1] if
        ``normed``).  Returns uint8 (image_size[1], image_size[0], 3)."""
        import cv2

        ini_size = (512, 512)
        image = np.zeros([ini_size[1], ini_size[0], 3], dtype=np.uint8)
        if normed:
            norm = keypoints[:, :2].astype(np.float64)
        else:
            norm = keypoints[:, :2].astype(np.float64) / np.asarray(
                [image_size[0], image_size[1]], dtype=np.float64
            )

        coords = {}
        for i in range(norm.shape[0]):
            x = self._pixel(norm[i, 0], ini_size[0])
            y = self._pixel(norm[i, 1], ini_size[1])
            if x is not None and y is not None:
                coords[i] = (x, y)

        for (a, b), color in self.face_connection_spec.items():
            if a in coords and b in coords:
                cv2.line(image, coords[a], coords[b], color, self.thickness)

        if (image_size[0], image_size[1]) != ini_size:
            image = cv2.resize(image, (image_size[0], image_size[1]))
        return image
