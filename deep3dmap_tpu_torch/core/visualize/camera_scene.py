"""Camera-frustum scene plots (port of
``deep3dmap_tpu/core/visualize/camera_scene.py``): a matplotlib 3D plot of
camera frusta and optional points, a host feature (matplotlib is imported
when a plot is made)."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def plot_camera_scene(poses: Sequence[np.ndarray], points: Optional[np.ndarray] = None,
                      scale: float = 0.1, title: str = "cameras",
                      save_path: Optional[str] = None):
    """poses: list of (4,4) or (3,4) camera-to-world matrices."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    frustum = np.array([[0, 0, 0], [-1, -1, 2], [1, -1, 2], [1, 1, 2],
                        [-1, 1, 2]]) * scale
    edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    for pose in poses:
        pose = np.asarray(pose)
        R, t = pose[:3, :3], pose[:3, 3]
        pts = frustum @ R.T + t
        for a, b in edges:
            ax.plot(*zip(pts[a], pts[b]), c="tab:blue", lw=0.8)
    if points is not None and len(points):
        ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=0.5, c="tab:gray")
    ax.set_title(title)
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return save_path
    return fig
