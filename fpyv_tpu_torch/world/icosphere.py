"""Geodesic icosphere meshes (host-side numpy, built once per world).

The reference imports the `icosphere` PyPI package (components.py:7,758:
``vertices, faces = icosphere(nu=nu)``) for target balls and their
rendering. That package is not in this image, so this is a from-scratch
implementation of the same construction: subdivide each icosahedron face
into nu² triangles on a barycentric grid and project to the unit sphere.
Vertex count = 10·nu² + 2, face count = 20·nu², matching the package's
(nu)-frequency convention.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np


def _icosahedron() -> Tuple[np.ndarray, np.ndarray]:
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        dtype=np.float64,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    return v, f


@lru_cache(maxsize=32)
def icosphere(nu: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Unit icosphere with subdivision frequency nu.

    Returns (vertices (10nu²+2, 3) float64, faces (20nu², 3) int64).
    """
    if nu < 1:
        raise ValueError("nu must be >= 1")
    base_v, base_f = _icosahedron()
    if nu == 1:
        return base_v.copy(), base_f.copy()

    verts: list = []
    vert_ids: dict = {}

    def vertex_id(weights) -> int:
        """weights: dict {icosa_vertex_id: integer barycentric weight}.
        Shared edge/corner points get identical keys across faces."""
        key = tuple(sorted((int(i), int(w)) for i, w in weights.items() if w > 0))
        if key not in vert_ids:
            p = sum(w * base_v[i] for i, w in weights.items())
            p = p / np.linalg.norm(p)
            vert_ids[key] = len(verts)
            verts.append(p)
        return vert_ids[key]

    faces = []
    for (a, b, c) in base_f:
        # barycentric grid: rows i = 0..nu (toward b/c), index grid[i][j]
        grid = []
        for i in range(nu + 1):
            row = []
            for j in range(i + 1):
                w = {a: nu - i, b: i - j, c: j}
                row.append(vertex_id(w))
            grid.append(row)
        for i in range(nu):
            for j in range(i + 1):
                faces.append([grid[i][j], grid[i + 1][j], grid[i + 1][j + 1]])
                if j < i:
                    faces.append([grid[i][j], grid[i + 1][j + 1], grid[i][j + 1]])

    return np.asarray(verts), np.asarray(faces, dtype=np.int64)
