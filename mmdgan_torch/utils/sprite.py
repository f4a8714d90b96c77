"""Sprite / embedding writers for qualitative evaluation
(``mmdgan_tpu/utils/sprite.py:16-102``; graph_func.py:183-396): a grid of
generated images as a PNG, and TensorBoard-projector files for scores.

The PNG is written here with ``zlib`` and ``struct`` (8-bit gray, RGB or
RGBA, filter 0), so no imaging library is needed; its pixels are those of
the JAX package's PIL-written file.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

_PNG_COLOR_TYPES = {1: 0, 3: 2, 4: 6}   # channels -> gray, RGB, RGBA


def write_png(path: str, image: np.ndarray) -> None:
    """An [H, W] or [H, W, C] uint8 array (C = 1, 3 or 4) as an 8-bit PNG."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim == 2:
        image = image[:, :, None]
    h, w, c = image.shape
    raw = b"".join(b"\x00" + image[row].tobytes() for row in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPES[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def images_to_sprite(
    images: np.ndarray,
    mesh_num: Optional[Tuple[int, int]] = None,
    if_invert: bool = False,
) -> np.ndarray:
    """[N, H, W, C] in [-1, 1] -> one [rows*H, cols*W, C] uint8 grid
    (graph_func.py:222-266)."""
    images = np.asarray(images, np.float32)
    n, h, w, c = images.shape
    if mesh_num is None:
        cols = int(np.ceil(np.sqrt(n)))
        rows = int(np.ceil(n / cols))
    else:
        rows, cols = mesh_num
    grid = np.ones((rows * h, cols * w, c), np.float32) * (1.0 if if_invert else -1.0)
    for i in range(n):
        r, cc = divmod(i, cols)
        img = -images[i] if if_invert else images[i]
        grid[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = img
    return np.clip((grid + 1.0) * 127.5, 0, 255).astype(np.uint8)


def write_sprite_wrapper(
    images: np.ndarray,
    mesh_num: Tuple[int, int],
    filename: str,
    file_folder: str,
    file_index: str = "",
    if_invert: bool = False,
    image_format: str = "channels_last",
) -> str:
    """Save a sprite PNG (graph_func.py:269-298). Returns the path."""
    if image_format in ("channels_first", "NCHW"):
        images = np.transpose(images, (0, 2, 3, 1))
    grid = images_to_sprite(images, mesh_num, if_invert)
    os.makedirs(file_folder, exist_ok=True)
    path = os.path.join(file_folder, filename + file_index + ".png")
    write_png(path, grid)
    return path


def embedding_image_wrapper(
    embeddings: np.ndarray,
    filename: str,
    var_name: str,
    file_folder: str,
    file_index: str = "",
    labels: Optional[np.ndarray] = None,
    images: Optional[np.ndarray] = None,
    mesh_num: Optional[Tuple[int, int]] = None,
    if_invert: bool = False,
    image_format: str = "channels_last",
) -> str:
    """TensorBoard-projector files: embeddings.tsv (+ metadata.tsv, sprite,
    projector_config.pbtxt) (graph_func.py:301-396)."""
    os.makedirs(file_folder, exist_ok=True)
    base = filename + file_index
    emb_path = os.path.join(file_folder, base + "_embeddings.tsv")
    np.savetxt(emb_path, np.asarray(embeddings), delimiter="\t")
    meta_path = None
    if labels is not None:
        meta_path = os.path.join(file_folder, base + "_metadata.tsv")
        np.savetxt(meta_path, np.asarray(labels).reshape(-1, 1), fmt="%d")
    sprite_path = None
    if images is not None:
        sprite_path = write_sprite_wrapper(
            images, mesh_num, base, file_folder, "_sprite",
            if_invert=if_invert, image_format=image_format,
        )
    cfg_path = os.path.join(file_folder, "projector_config.pbtxt")
    with open(cfg_path, "a") as f:
        f.write("embeddings {\n")
        f.write(f'  tensor_name: "{var_name}"\n')
        f.write(f'  tensor_path: "{os.path.basename(emb_path)}"\n')
        if meta_path:
            f.write(f'  metadata_path: "{os.path.basename(meta_path)}"\n')
        if sprite_path and images is not None:
            h, w = images.shape[1:3] if image_format == "channels_last" else images.shape[2:4]
            f.write("  sprite {\n")
            f.write(f'    image_path: "{os.path.basename(sprite_path)}"\n')
            f.write(f"    single_image_dim: {w}\n    single_image_dim: {h}\n")
            f.write("  }\n")
        f.write("}\n")
    return emb_path
