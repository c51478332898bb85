"""Image file I/O and conversions.

Provides the image half of the reference's external ``handy_function``
surface (``image_read`` / ``image_save`` / grayscale, see SURVEY.md §1 L1).
Images are RGB uint8 numpy arrays in this framework (the reference keeps
OpenCV BGR; conversion happens at the file boundary only).
"""

from __future__ import annotations

import numpy as np


def _cv2():
    """OpenCV if installed, else None (PIL is the fallback). Imported on
    first use, so the matching path needs neither."""
    try:
        import cv2
    except ImportError:  # pragma: no cover
        return None
    return cv2


def image_read(path: str, grayscale: bool = False) -> np.ndarray:
    """Read an image file as RGB (or single-channel) uint8."""
    cv2 = _cv2()
    if cv2 is not None:
        flag = cv2.IMREAD_GRAYSCALE if grayscale else cv2.IMREAD_COLOR
        img = cv2.imread(str(path), flag)
        if img is None:
            raise FileNotFoundError(path)
        if not grayscale:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        return img
    from PIL import Image
    img = Image.open(path)
    img = img.convert("L" if grayscale else "RGB")
    return np.asarray(img)


def image_save(path: str, image: np.ndarray) -> None:
    """Save an RGB / grayscale / float image to disk.

    Float images are min-max normalized to uint8 like the reference's
    disparity dumps (``plot_functions.py:99-100``).
    """
    img = np.asarray(image)
    if img.dtype != np.uint8:
        lo, hi = float(np.nanmin(img)), float(np.nanmax(img))
        scale = 255.0 / (hi - lo) if hi > lo else 0.0
        img = ((img - lo) * scale).astype(np.uint8)
    cv2 = _cv2()
    if cv2 is not None:
        out = img
        if img.ndim == 3 and img.shape[2] == 3:
            out = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
        if not cv2.imwrite(str(path), out):
            raise IOError(f"failed to write {path}")
    else:
        from PIL import Image
        Image.fromarray(img).save(path)


def to_grayscale(image: np.ndarray) -> np.ndarray:
    """RGB -> single-channel luma (ITU-R BT.601, matching cv2.cvtColor)."""
    img = np.asarray(image)
    if img.ndim == 2:
        return img
    w = np.array([0.299, 0.587, 0.114], dtype=np.float32)
    gray = img[..., :3].astype(np.float32) @ w
    if img.dtype == np.uint8:
        return np.round(gray).astype(np.uint8)
    return gray.astype(img.dtype)


def normalize_to_uint8(image: np.ndarray) -> np.ndarray:
    """Min-max normalize to [0, 255] uint8 (``plot_functions.py:99-100``)."""
    img = np.asarray(image, np.float64)
    lo, hi = np.nanmin(img), np.nanmax(img)
    if hi <= lo:
        return np.zeros(img.shape, np.uint8)
    return ((img - lo) * (255.0 / (hi - lo))).astype(np.uint8)
