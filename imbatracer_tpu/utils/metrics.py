"""Image error metrics matching the reference bench harness.

The reference computes RMSE with ImageMagick `compare -metric RMSE`
against 8-bit golden PNGs (reference: test/run_bench.py:113-129); we
reproduce that: both images are tone-mapped (gamma 0.5 default,
cmd_line.h:77), quantised to 8 bits, and RMSE is reported normalised to
[0, 1].  PSNR is derived from the same quantity.
"""

from __future__ import annotations

import numpy as np


def quantize(img01: np.ndarray) -> np.ndarray:
    return np.clip(img01 * 255.0 + 0.5, 0, 255).astype(np.uint8)


def rmse(a01: np.ndarray, b01: np.ndarray) -> float:
    """Normalised RMSE between two [0,1] RGB images after 8-bit quantisation
    (ImageMagick-compatible)."""
    a = quantize(a01).astype(np.float64) / 255.0
    b = quantize(b01).astype(np.float64) / 255.0
    return float(np.sqrt(np.mean((a - b) ** 2)))


def psnr(a01: np.ndarray, b01: np.ndarray) -> float:
    r = rmse(a01, b01)
    if r <= 0:
        return float("inf")
    return float(-20.0 * np.log10(r))


def load_reference_png(path: str) -> np.ndarray:
    """Load a golden PNG as [0,1] RGB (already tone-mapped)."""
    from ..io.image import load_png

    return load_png(path)[..., :3]
