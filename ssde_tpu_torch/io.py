"""Image/depth IO helpers (reference util/io.py:14-216, util/pallete.py).

PFM read/write, 16-bit depth PNG export, magma-colormapped disparity
visualization, and segmentation palettes. A copy of ``ssde_tpu/io.py``, so
that the port imports nothing of ``ssde_tpu``;
``tests/test_torch_eval_copies.py`` holds it to the original.
"""

from __future__ import annotations

import re
import struct
import sys

import numpy as np


def read_pfm(path: str):
    """Read a PFM file -> (data, scale)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError("Not a PFM file: " + path)

        dims = f.readline()
        while dims.startswith(b"#"):
            dims = f.readline()
        m = re.match(rb"^(\d+)\s(\d+)\s$", dims)
        if not m:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, m.groups())

        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        data = np.fromfile(f, endian + "f")
        shape = (height, width, 3) if color else (height, width)
        data = np.reshape(data, shape)
        data = np.flipud(data)
        return data, scale


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0):
    """Write a float32 image as PFM."""
    if image.dtype.name != "float32":
        raise ValueError("Image dtype must be float32.")
    image = np.flipud(image)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError("Image must have H x W x 3, H x W x 1 or H x W dims.")

    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and sys.byteorder == "little"):
            scale = -scale
        f.write(f"{scale}\n".encode())
        image.tofile(f)


def write_depth_png(path: str, depth: np.ndarray, bits: int = 2):
    """Write depth as a {8,16}-bit grayscale PNG, normalized to full range
    (reference util/io.py write_depth)."""
    from PIL import Image

    depth = np.asarray(depth, dtype=np.float64)
    depth_min, depth_max = depth.min(), depth.max()
    max_val = (2 ** (8 * bits)) - 1
    if depth_max - depth_min > np.finfo("float").eps:
        out = max_val * (depth - depth_min) / (depth_max - depth_min)
    else:
        out = np.zeros_like(depth)
    if bits == 1:
        Image.fromarray(out.astype(np.uint8)).save(path)
    else:
        Image.fromarray(out.astype(np.uint16)).save(path)


def colormap_disparity(disp: np.ndarray, percentile: float = 95.0) -> np.ndarray:
    """Magma-colormapped uint8 RGB visualization of a disparity map
    (reference test_simple.py:135-143)."""
    import matplotlib.cm as cm

    vmax = np.percentile(disp, percentile)
    normed = np.clip(disp / max(vmax, 1e-9), 0, 1)
    return (cm.get_cmap("magma")(normed)[..., :3] * 255).astype(np.uint8)


# 21-class VOC-style segmentation palette (reference util/pallete.py)
def get_mask_pallete(npimg: np.ndarray, dataset: str = "pascal_voc"):
    """Map a class-index image to a paletted PIL image."""
    from PIL import Image

    out = Image.fromarray(npimg.squeeze().astype("uint8"))
    out.putpalette(_build_palette(256))
    return out


def _build_palette(num_cls: int):
    n = num_cls
    palette = [0] * (n * 3)
    for j in range(n):
        lab = j
        palette[j * 3 + 0] = 0
        palette[j * 3 + 1] = 0
        palette[j * 3 + 2] = 0
        i = 0
        while lab:
            palette[j * 3 + 0] |= ((lab >> 0) & 1) << (7 - i)
            palette[j * 3 + 1] |= ((lab >> 1) & 1) << (7 - i)
            palette[j * 3 + 2] |= ((lab >> 2) & 1) << (7 - i)
            i += 1
            lab >>= 3
    return palette
