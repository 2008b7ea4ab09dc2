"""Filesystem helpers (counterpart of ``pytorch_toolbelt_tpu/utils/fs.py``).

The image readers import ``cv2``, or PIL without it, when they are called."""

import glob
import os
import zipfile
from typing import List, Union

import numpy as np

__all__ = [
    "has_ext",
    "has_image_ext",
    "find_in_dir",
    "find_in_dir_glob",
    "find_in_dir_with_ext",
    "find_images_in_dir",
    "find_images_in_dir_recursive",
    "find_subdirectories_in_dir",
    "id_from_fname",
    "change_extension",
    "auto_file",
    "read_rgb_image",
    "read_image_as_is",
    "zipdir",
]

IMAGE_EXTENSIONS = {".bmp", ".png", ".jpeg", ".jpg", ".tif", ".tiff", ".webp"}


def has_ext(fname: str, extensions: Union[str, List[str], tuple]) -> bool:
    """True when fname's extension is one of `extensions` (case-insensitive).

    Parity target: pytorch_toolbelt/utils/fs.py:33-41.
    """
    if not isinstance(extensions, (str, list, tuple)):
        raise ValueError("Argument extensions must be either string or list of strings")
    if isinstance(extensions, str):
        extensions = [extensions]
    wanted = {e.lower() for e in extensions}
    return os.path.splitext(fname)[1].lower() in wanted


def has_image_ext(fname: str) -> bool:
    return os.path.splitext(fname)[1].lower() in IMAGE_EXTENSIONS


def find_in_dir_glob(pattern: str, recursive: bool = False) -> List[str]:
    """Sorted glob expansion."""
    return sorted(glob.iglob(pattern, recursive=recursive))


def find_in_dir(dirname: str) -> List[str]:
    return [os.path.join(dirname, fname) for fname in sorted(os.listdir(dirname))]


def find_in_dir_with_ext(dirname: str, extensions: Union[str, List[str]]) -> List[str]:
    if isinstance(extensions, str):
        extensions = [extensions]
    extensions = {e.lower() for e in extensions}
    return [f for f in find_in_dir(dirname) if os.path.splitext(f)[1].lower() in extensions]


def find_images_in_dir(dirname: str) -> List[str]:
    return [f for f in find_in_dir(dirname) if has_image_ext(f)]


def find_images_in_dir_recursive(dirname: str) -> List[str]:
    return sorted(
        f for f in glob.glob(os.path.join(dirname, "**", "*"), recursive=True) if has_image_ext(f)
    )


def find_subdirectories_in_dir(dirname: str) -> List[str]:
    return [f for f in find_in_dir(dirname) if os.path.isdir(f)]


def id_from_fname(fname: str) -> str:
    return os.path.splitext(os.path.basename(fname))[0]


def change_extension(fname: str, new_ext: str) -> str:
    if not new_ext.startswith("."):
        new_ext = "." + new_ext
    return os.path.splitext(fname)[0] + new_ext


def auto_file(filename: str, where: str = ".") -> str:
    """Find a unique file by name recursively under ``where``
    ."""
    if os.path.isabs(filename) or os.path.exists(filename):
        return filename
    prob = os.path.join(where, filename)
    if os.path.exists(prob) and os.path.isfile(prob):
        return prob
    files = list(glob.iglob(os.path.join(where, "**", filename), recursive=True))
    if len(files) == 0:
        raise FileNotFoundError(f"Given file could not be found with recursive search: {filename}")
    if len(files) > 1:
        raise FileNotFoundError(f"More than one file matches given filename. Please specify it explicitly:\n" + "\n".join(files))
    return files[0]


def read_rgb_image(fname: str) -> np.ndarray:
    """Read image as RGB HWC uint8."""
    try:
        import cv2

        image = cv2.imread(fname, cv2.IMREAD_COLOR)
        if image is None:
            raise IOError(f"Cannot read image '{fname}'")
        return cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(fname).convert("RGB"))


def read_image_as_is(fname: str) -> np.ndarray:
    try:
        import cv2

        image = cv2.imread(fname, cv2.IMREAD_UNCHANGED)
        if image is None:
            raise IOError(f"Cannot read image '{fname}'")
        return image
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(fname))


def zipdir(path: str, ziph: zipfile.ZipFile) -> None:
    for root, dirs, files in os.walk(path):
        for file in files:
            ziph.write(os.path.join(root, file))
