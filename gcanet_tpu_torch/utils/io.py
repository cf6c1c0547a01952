"""Point-cloud file IO (port of ``gcanet_tpu/utils/io.py``): .ply / .xyz
writers and readers in numpy.

The reference's open3d-backed ``write_ply`` and text loops
(utils/main_utils.py:58-111) become dependency-free numpy: ASCII PLY is a
fixed header plus the same rows the .xyz path writes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def write_ply(fn: str, point: np.ndarray, normal: Optional[np.ndarray] = None,
              color: Optional[np.ndarray] = None) -> None:
    """ASCII PLY with optional per-vertex normals and colors
    (main_utils.py:58-72 via open3d; colors may be [0,1] floats or uint8)."""
    point = np.asarray(point, np.float64)
    n = len(point)
    cols = [point]
    props = ["property float x", "property float y", "property float z"]
    if normal is not None:
        cols.append(np.asarray(normal, np.float64))
        props += ["property float nx", "property float ny", "property float nz"]
    if color is not None:
        c = np.asarray(color)
        if np.issubdtype(c.dtype, np.floating):
            c = np.clip(np.round(c * 255.0), 0, 255)
        cols.append(c.astype(np.float64))
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    header = "\n".join(
        ["ply", "format ascii 1.0", f"element vertex {n}"] + props
        + ["end_header"])
    body = np.column_stack(cols)
    ncoord = body.shape[1] - (3 if color is not None else 0)
    fmt = ["%.8f"] * ncoord + (["%d"] * 3 if color is not None else [])
    with open(fn, "w") as f:
        f.write(header + "\n")
        np.savetxt(f, body, fmt=" ".join(fmt))


def read_ply(fn: str) -> Tuple[np.ndarray, Optional[np.ndarray],
                               Optional[np.ndarray]]:
    """Read an ASCII PLY written by :func:`write_ply` ->
    (points, normals | None, colors[0,1] | None)."""
    with open(fn) as f:
        props = []
        for line in f:
            line = line.strip()
            if line.startswith("property"):
                props.append(line.split()[-1])
            if line == "end_header":
                break
        data = np.loadtxt(f, ndmin=2)
    cols = {p: data[:, i] for i, p in enumerate(props)}
    pts = np.column_stack([cols["x"], cols["y"], cols["z"]])
    nrm = np.column_stack([cols["nx"], cols["ny"], cols["nz"]]) \
        if "nx" in cols else None
    rgb = np.column_stack([cols["red"], cols["green"], cols["blue"]]) / 255.0 \
        if "red" in cols else None
    return pts, nrm, rgb


def write_xyz_files(output_path: str, point: np.ndarray,
                    normal: Optional[np.ndarray] = None) -> None:
    """main_utils.py:75-94: rows of ``x y z [nx ny nz]``."""
    body = np.asarray(point, np.float64) if normal is None else \
        np.column_stack([point, normal])
    np.savetxt(output_path, body, fmt="%f")


def read_xyz_files(filename: str, normal: bool = True):
    """main_utils.py:97-117: -> points [N,3] (and normals [N,3] if asked)."""
    data = np.loadtxt(filename, ndmin=2)
    if normal:
        return data[:, :3], data[:, 3:6]
    return data[:, :3]
