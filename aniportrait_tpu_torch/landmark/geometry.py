"""Face geometry solver: screen landmarks -> canonical-frame mesh + rigid

The port's copy of ``aniportrait_tpu/landmark/geometry.py`` (held to it by
``tests/test_torch_copies.py``).
head-pose matrix.

Native-equivalent of MediaPipe's face-geometry module (the C++ pipeline the
reference relies on, SURVEY §2.1): loads the canonical mesh + Procrustes
landmark basis from ``geometry_pipeline_metadata_landmarks.binarypb``
(parsed with a minimal protobuf wire reader — no protobuf dependency) and
estimates a weighted-Procrustes similarity from the canonical mesh to the
perspective-unprojected landmarks.

Output contract (what the downstream math actually uses,
reference pose_util.py:30-43 / vid2vid.py:174-197):
  * ``mesh``    — the frame's landmarks rigidly aligned into the canonical
    frame (canonical cm scale; expression preserved, pose removed) — the
    reference's ``lmks3d``.
  * ``trans_mat`` — RIGID 4x4 (rotation + translation in canonical units)
    such that perspective-projecting ``trans_mat @ mesh`` with the
    reference's 63-deg-FoV matrix (pose_util.create_perspective_matrix)
    reproduces the detected screen landmarks.  Perspective projection is
    scale-invariant along rays, so folding the Procrustes scale into the
    translation keeps the matrix rigid exactly like MediaPipe's.
"""

from __future__ import annotations

import math
import struct
import zipfile
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

VFOV_DEGREES = 63.0  # MediaPipe default environment; pose_util.py:14


# ------------------------------------------------------- protobuf wire reader
def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_message(buf: bytes) -> Dict[int, List]:
    """Parse one protobuf message into {field_number: [raw values]}."""
    fields: Dict[int, List] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field, []).append(val)
    return fields


@dataclass
class GeometryMetadata:
    canonical_mesh: np.ndarray  # (468, 5) x,y,z,u,v
    procrustes_ids: np.ndarray  # (k,)
    procrustes_weights: np.ndarray  # (k,)


def _floats(field_vals) -> np.ndarray:
    """Repeated float field: either packed (one length-delimited blob) or
    unpacked (many 4-byte fixed32 entries)."""
    raw = b"".join(field_vals)
    return np.frombuffer(raw, dtype="<f4")


def _uints(field_vals) -> np.ndarray:
    """Repeated uint32: packed varint blob(s) or unpacked varint ints."""
    if field_vals and isinstance(field_vals[0], int):
        return np.asarray(field_vals, np.uint32)
    out = []
    for blob in field_vals:
        pos = 0
        while pos < len(blob):
            v, pos = _read_varint(blob, pos)
            out.append(v)
    return np.asarray(out, np.uint32)


def load_geometry_metadata(task_path: str) -> GeometryMetadata:
    """Read the metadata out of the face_landmarker .task bundle.

    Observed schema (this bundle): field 1 = Mesh3d {3: repeated float
    vertex_buffer (x,y,z,u,v per vertex), 4: repeated uint32 index_buffer},
    field 2 = repeated WeightedLandmarkRef {1: uint32 id, 2: float weight}.
    """
    with zipfile.ZipFile(task_path) as z:
        raw = z.read("geometry_pipeline_metadata_landmarks.binarypb")
    top = parse_message(raw)

    mesh_msg = parse_message(top[1][0])
    verts = _floats(mesh_msg[3]).reshape(-1, 5)

    ids, weights = [], []
    for item in top.get(2, []):
        m = parse_message(item)
        ids.append(int(m[1][0]))
        weights.append(struct.unpack("<f", m[2][0])[0])
    return GeometryMetadata(
        canonical_mesh=np.ascontiguousarray(verts),
        procrustes_ids=np.asarray(ids, np.int64),
        procrustes_weights=np.asarray(weights, np.float32),
    )


# ------------------------------------------------------------------ solver
def weighted_umeyama(src: np.ndarray, dst: np.ndarray, w: np.ndarray):
    """Weighted similarity transform dst ~ s R src + t.  Returns (s, R, t)."""
    w = w / w.sum()
    mu_s = (w[:, None] * src).sum(0)
    mu_d = (w[:, None] * dst).sum(0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = (w[:, None, None] * (dc[:, :, None] * sc[:, None, :])).sum(0)
    var_s = (w * (sc**2).sum(1)).sum()
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = np.trace(np.diag(D) @ S) / var_s
    t = mu_d - s * R @ mu_s
    return s, R, t


class GeometrySolver:
    def __init__(self, metadata: GeometryMetadata):
        self.meta = metadata
        self.canonical = metadata.canonical_mesh[:, :3].astype(np.float64)
        self.ids = metadata.procrustes_ids
        self.w = metadata.procrustes_weights.astype(np.float64)

    def solve(self, landmarks: np.ndarray, image_size: Tuple[int, int]):
        """
        Args:
          landmarks: (>=468, 3) normalised screen landmarks (x, y in [0,1],
            z relative, MediaPipe convention: scaled like x).
          image_size: (width, height).
        Returns: dict(mesh (468,3), trans_mat (4,4) float32)
        """
        W, H = image_size
        aspect = W / H
        f = 1.0 / math.tan(math.radians(VFOV_DEGREES) / 2.0)

        lm = landmarks[: self.canonical.shape[0]].astype(np.float64)
        ndc_x = 2.0 * lm[:, 0] - 1.0
        ndc_y = 2.0 * lm[:, 1] - 1.0
        ndc_z = 2.0 * lm[:, 2]  # relative depth, x-like scaling

        def unproject(depths):
            # camera space (z < 0 in front):  x = -ndc_x * z * a / f,
            # y = ndc_y * z / f  (matches pose_util's row-vector projection
            # x_ndc = -(f/a) x / z ; y_ndc = f y / z)
            x = -ndc_x * depths * aspect / f
            y = ndc_y * depths / f
            return np.stack([x, y, depths], axis=1)

        # pass 1: flat depth -1, estimate scale -> true depth
        pts = unproject(np.full_like(ndc_x, -1.0))
        s1, _, _ = weighted_umeyama(
            self.canonical[self.ids], pts[self.ids], self.w
        )
        d0 = 1.0 / max(s1, 1e-9)

        # pass 2: per-point depth from relative z
        depths = -(d0 + ndc_z * d0 * aspect / f)
        pts = unproject(depths)
        s, R, t = weighted_umeyama(self.canonical[self.ids], pts[self.ids], self.w)

        # canonical-frame mesh (expression kept, pose removed, cm scale)
        mesh = ((pts - t) @ R) / s  # == (1/s) R^T (pts - t)

        trans_mat = np.eye(4)
        trans_mat[:3, :3] = R
        trans_mat[:3, 3] = t / s  # rigid matrix; perspective is scale-invariant
        return {
            "mesh": mesh.astype(np.float32),
            "trans_mat": trans_mat.astype(np.float32),
        }
