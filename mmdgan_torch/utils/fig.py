"""Fig: matplotlib plotting wrappers for offline analysis, the counterpart
of ``mmdgan_tpu/utils/fig.py`` (the reference's ``Fig``,
graph_func.py:1306-1592): hist, hist2d, scatter, contour and text-scatter
plots, drawn or saved to ``<fig_folder>/<filename>.<fig_format>``.

Matplotlib is imported inside the plotting calls, on its Agg backend, so
the module imports where matplotlib is missing (the card's machine) and
draws headless where it is present. Inputs are numpy arrays or CPU
tensors.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


class Fig:
    def __init__(self, fig_folder: Optional[str] = None, fig_format: str = "png",
                 dpi: int = 150):
        self.fig_folder = fig_folder
        self.fig_format = fig_format
        self.dpi = dpi

    def _finish(self, fig, filename: Optional[str]):
        plt = _plt()
        if filename is not None:
            folder = self.fig_folder or "."
            os.makedirs(folder, exist_ok=True)
            path = os.path.join(folder, f"{filename}.{self.fig_format}")
            fig.savefig(path, dpi=self.dpi, bbox_inches="tight")
            plt.close(fig)
            return path
        return fig

    def hist(self, x, bins: int = 50, filename: Optional[str] = None,
             xlabel: str = "", title: str = ""):
        plt = _plt()
        fig, ax = plt.subplots()
        ax.hist(np.asarray(x).ravel(), bins=bins)
        ax.set_xlabel(xlabel)
        ax.set_title(title)
        return self._finish(fig, filename)

    def hist2d(self, x, y=None, bins: int = 60, filename: Optional[str] = None,
               title: str = ""):
        plt = _plt()
        arr = np.asarray(x)
        if y is None:
            xv, yv = arr[:, 0], arr[:, 1]
        else:
            xv, yv = arr.ravel(), np.asarray(y).ravel()
        fig, ax = plt.subplots()
        ax.hist2d(xv, yv, bins=bins)
        ax.set_title(title)
        return self._finish(fig, filename)

    def scatter(self, x, y=None, labels=None, filename: Optional[str] = None,
                title: str = "", s: float = 4.0):
        plt = _plt()
        arr = np.asarray(x)
        if y is None:
            xv, yv = arr[:, 0], arr[:, 1]
        else:
            xv, yv = arr.ravel(), np.asarray(y).ravel()
        fig, ax = plt.subplots()
        sc = ax.scatter(xv, yv, c=labels, s=s, cmap="tab10")
        if labels is not None:
            fig.colorbar(sc, ax=ax)
        ax.set_title(title)
        return self._finish(fig, filename)

    def contour(self, fun, grid=None, num: int = 100,
                filename: Optional[str] = None, title: str = "", levels: int = 20):
        """Contour of fun([N,2]) -> [N] over a 2-D grid."""
        plt = _plt()
        if grid is None:
            grid = [[-1.0, 1.0], [-1.0, 1.0]]
        xs = np.linspace(grid[0][0], grid[0][1], num)
        ys = np.linspace(grid[1][0], grid[1][1], num)
        xx, yy = np.meshgrid(xs, ys)
        pts = np.stack([xx.ravel(), yy.ravel()], axis=1)
        zz = np.asarray(fun(pts)).reshape(num, num)
        fig, ax = plt.subplots()
        cs = ax.contourf(xx, yy, zz, levels=levels)
        fig.colorbar(cs, ax=ax)
        ax.set_title(title)
        return self._finish(fig, filename)

    def text_scatter(self, x, texts: Sequence[str], filename: Optional[str] = None,
                     title: str = ""):
        plt = _plt()
        arr = np.asarray(x)
        fig, ax = plt.subplots()
        ax.scatter(arr[:, 0], arr[:, 1], s=1, alpha=0)
        for (px, py), t in zip(arr[:, :2], texts):
            ax.text(px, py, str(t), fontsize=7)
        ax.set_title(title)
        return self._finish(fig, filename)
