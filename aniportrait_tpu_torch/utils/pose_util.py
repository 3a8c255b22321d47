"""Head-pose / projection math (numpy, host-side).

The port's copy of ``aniportrait_tpu/utils/pose_util.py`` (held to it by
``tests/test_torch_copies.py``).

Parity target: reference ``src/utils/pose_util.py`` — 63deg-FoV perspective
matrix with Y-flip, mesh projection with per-frame pose, euler<->matrix
conversions, moving-average smoothing.  Vectorised over frames (the
reference loops per frame).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as R


def create_perspective_matrix(aspect_ratio: float) -> np.ndarray:
    """Column-major 16-vector, as the reference builds it (pose_util.py:7-27)."""
    k_degrees_to_radians = np.pi / 180.0
    near, far = 1.0, 10000.0
    perspective_matrix = np.zeros(16, dtype=np.float32)
    f = 1.0 / np.tan(k_degrees_to_radians * 63 / 2.0)
    denom = 1.0 / (near - far)
    perspective_matrix[0] = f / aspect_ratio
    perspective_matrix[5] = f
    perspective_matrix[10] = (near + far) * denom
    perspective_matrix[11] = -1.0
    perspective_matrix[14] = 1.0 * far * near * denom
    perspective_matrix[5] *= -1.0  # top-left origin Y flip
    return perspective_matrix


def euler_and_translation_to_matrix(euler_angles, translation_vector) -> np.ndarray:
    rotation_matrix = R.from_euler("xyz", euler_angles, degrees=True).as_matrix()
    matrix = np.eye(4)
    matrix[:3, :3] = rotation_matrix
    matrix[:3, 3] = translation_vector
    return matrix


def matrix_to_euler_and_translation(matrix):
    rotation_matrix = matrix[:3, :3]
    translation_vector = matrix[:3, 3]
    euler_angles = R.from_matrix(rotation_matrix).as_euler("xyz", degrees=True)
    return euler_angles, translation_vector


def _project_homogeneous(points_h: np.ndarray, image_shape) -> np.ndarray:
    """(L, N, 4) clip-space points -> (L, N, 2) pixel coords."""
    xy = points_h[..., :2] / points_h[..., 3:4]
    out = np.empty_like(xy)
    out[..., 0] = (xy[..., 0] + 1) * 0.5 * image_shape[1]
    out[..., 1] = (xy[..., 1] + 1) * 0.5 * image_shape[0]
    return out


def project_points(points_3d, transformation_matrix, pose_vectors, image_shape):
    """(L, N, 3) mesh x (4,4) trans_mat x per-frame 6-DoF pose -> (L, N, 2)."""
    P = create_perspective_matrix(image_shape[1] / image_shape[0]).reshape(4, 4).T
    points_3d = np.asarray(points_3d, dtype=np.float64)
    L, N, _ = points_3d.shape
    ones = np.ones((L, N, 1))
    points_h = np.concatenate([points_3d, ones], axis=-1)
    # per-frame full transform: trans_mat @ pose_matrix(frame)
    mats = np.stack(
        [
            transformation_matrix
            @ euler_and_translation_to_matrix(pose_vectors[i][:3], pose_vectors[i][3:])
            for i in range(L)
        ]
    )  # (L, 4, 4)
    transformed = np.einsum("lnk,ljk->lnj", points_h, mats) @ P
    return _project_homogeneous(transformed, image_shape)


def project_points_with_trans(points_3d, transformation_matrix, image_shape):
    """(L, N, 3) mesh x per-frame (L, 4, 4) transforms -> (L, N, 2)."""
    P = create_perspective_matrix(image_shape[1] / image_shape[0]).reshape(4, 4).T
    points_3d = np.asarray(points_3d, dtype=np.float64)
    L, N, _ = points_3d.shape
    ones = np.ones((L, N, 1))
    points_h = np.concatenate([points_3d, ones], axis=-1)
    transformed = np.einsum("lnk,ljk->lnj", points_h, transformation_matrix) @ P
    return _project_homogeneous(transformed, image_shape)


def smooth_pose_seq(pose_seq: np.ndarray, window_size: int = 5) -> np.ndarray:
    """Centered moving average with edge clamping (pose_util.py:81-88)."""
    smoothed = np.zeros_like(pose_seq)
    n = len(pose_seq)
    for i in range(n):
        start = max(0, i - window_size // 2)
        end = min(n, i + window_size // 2 + 1)
        smoothed[i] = np.mean(pose_seq[start:end], axis=0)
    return smoothed
