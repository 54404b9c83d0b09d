"""3D rotation utilities (numpy, host side; the port's own copy of
``fastegnn_tpu/ops/rotation.py``).

Semantics mirror the reference's test-time augmentation
(``utils/rotate.py:35-49``): integer-degree angles composed Rx @ Ry @ Rz,
and a y-axis-only variant for the gravity-aligned Water-3D dataset
(``datasets/simulation/dataset.py:71-77``).  Rotations are applied on the
host during dataset construction, so these stay numpy.
"""

from __future__ import annotations

import numpy as np


def rotation_x(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def rotation_y(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def rotation_z(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def random_rotation(rng: np.random.Generator) -> np.ndarray:
    """Random integer-degree XYZ rotation composition (ref ``utils/rotate.py:35-42``)."""
    x, y, z = (np.radians(rng.integers(0, 361)) for _ in range(3))
    return rotation_x(x) @ rotation_y(y) @ rotation_z(z)


def random_rotation_y(rng: np.random.Generator) -> np.ndarray:
    """Random integer-degree rotation about y only (ref ``utils/rotate.py:44-49``)."""
    return rotation_y(np.radians(rng.integers(0, 361)))
