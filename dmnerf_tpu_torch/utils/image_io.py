"""Image files through Pillow, the arrays ``imageio.v2`` gives and the bytes it writes.

The JAX package reads and writes its PNG and JPEG files with imageio, whose Pillow plugin
does the work; the port calls Pillow itself, so it runs on hosts that have Pillow but no
imageio. A palette image reads as its palette's mode (RGB or RGBA), as imageio reads it.
"""

from __future__ import annotations

import numpy as np


def imread(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        if im.mode == "P":
            im = im.convert(im.palette.mode)
        return np.asarray(im)


def imwrite(path: str, img: np.ndarray) -> None:
    """Writes ``img`` (uint8 [H, W] or [H, W, 3|4]) in the format of the path's suffix."""
    from PIL import Image

    Image.fromarray(np.asarray(img)).save(path)
