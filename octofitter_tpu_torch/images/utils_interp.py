"""Differentiable image interpolation.

PyTorch port of `octofitter_tpu/images/utils_interp.py`: the bilinear
lookup of `map_coordinates(order=1, mode="nearest")` as four gathers from
the flattened pixels, over any batch of points, and over a stack of
same-shaped images at once.
"""

from __future__ import annotations

import torch


def interp_image_centered(image, x, y):
    """Bilinear interpolation of a centered image at pixel coordinates
    (x, y), where (0, 0) is the image centre, x indexes columns and y rows;
    NaN outside the image.

    image: (ny, nx), or a stack (G, ny, nx) whose g-th image is read at
    x[..., g], y[..., g]. x and y broadcast together. As
    `map_coordinates(order=1, mode="nearest")`: the lower corner is the
    floor of the coordinate, and each corner's index is clamped to the
    edge on its own. The NaN outside is a constant, so it leaks nothing
    into the gradient of the coordinates."""
    x, y = torch.broadcast_tensors(x, y)
    ny, nx = image.shape[-2:]
    col = x + (nx - 1) / 2.0
    row = y + (ny - 1) / 2.0
    inside = (col >= 0) & (col <= nx - 1) & (row >= 0) & (row <= ny - 1)

    def nodes(c, size):
        lower = torch.floor(c)
        upper_w = c - lower
        # clamp in floating point first: a NaN or huge coordinate has no
        # defined integer conversion
        i = torch.clamp(lower, -1.0, float(size)).to(torch.int64)
        return ((torch.clamp(i, 0, size - 1), 1 - upper_w),
                (torch.clamp(i + 1, 0, size - 1), upper_w))

    flat = image.reshape(-1)
    if image.ndim == 3:
        base = torch.arange(image.shape[0], device=image.device) * (ny * nx)
    else:
        base = 0
    out = None
    # the corners in map_coordinates' order, summed left to right
    for ri, rw in nodes(row, ny):
        for ci, cw in nodes(col, nx):
            term = (rw * cw) * flat[base + ri * nx + ci]
            out = term if out is None else out + term
    return torch.where(inside, out, torch.nan)
