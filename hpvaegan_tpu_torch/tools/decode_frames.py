"""Decode a clip or an image once into the frames file the port reads.

    python -m hpvaegan_tpu_torch.tools.decode_frames data/vids/wingsuit.avi
    python -m hpvaegan_tpu_torch.tools.decode_frames photo.jpg

writes ``data/vids/wingsuit.frames.npz`` beside the clip: ``frames``
(N, H, W, 3) uint8 RGB at the clip's own size, every frame, and ``fps``.
It does what ``video_to_frames`` (``hpvaegan_tpu/data/video.py:26-56``)
does up to the resize: OpenCV's decode, BGR -> RGB, the 500-null-read
guard.  The per-scale resize happens in the dataset
(``hpvaegan_tpu_torch/data/video.py``), which needs no OpenCV, so a clip
decoded here trains on a machine without it.

An image (a file with an extension of ``IMAGE_EXTENSIONS``) becomes
``<image stem>.frames.npz`` with one frame, RGB uint8, and ``fps`` 0: the
frames file that ``data/image.py`` reads for a format other than PNG,
which the port reads itself (``utils/png.py``).  The JAX package decodes
images with imageio; OpenCV decodes PNG and BMP to the same pixels, and a
JPEG possibly a level off where the two carry different libjpeg builds.

This is the port's only module that imports ``cv2``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

__all__ = ["frames_path", "decode_frames", "decode_image",
           "IMAGE_EXTENSIONS"]

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff",
                    ".webp")


def frames_path(video_path: str) -> str:
    """``<dir>/<clip stem>.frames.npz`` for ``<dir>/<clip stem>.<ext>``."""
    stem, _ = os.path.splitext(video_path)
    return stem + ".frames.npz"


def decode_frames(video_path: str, out: str = "") -> str:
    """Decode every frame of ``video_path``; returns the file written."""
    import cv2

    if not os.path.isfile(video_path):
        raise FileNotFoundError(video_path)
    capture = cv2.VideoCapture(video_path)
    try:
        fps = float(capture.get(cv2.CAP_PROP_FPS))
        total = int(capture.get(cv2.CAP_PROP_FRAME_COUNT))
        frames, null_reads = [], 0
        while len(frames) < total and null_reads <= 500:
            _, image = capture.read()
            if image is None:
                null_reads += 1
                continue
            null_reads = 0
            frames.append(cv2.cvtColor(image, cv2.COLOR_BGR2RGB))
    finally:
        capture.release()
    if not frames:
        raise RuntimeError(f"no frame decoded from {video_path}")
    out = out or frames_path(video_path)
    tmp = out + ".tmp.npz"
    np.savez_compressed(tmp, frames=np.stack(frames).astype(np.uint8),
                        fps=np.float64(fps))
    os.replace(tmp, out)
    return out


def decode_image(image_path: str, out: str = "") -> str:
    """Decode ``image_path`` into a one-frame frames file (RGB, alpha
    dropped, gray spread to three channels); returns the file written."""
    import cv2

    if not os.path.isfile(image_path):
        raise FileNotFoundError(image_path)
    image = cv2.imread(image_path, cv2.IMREAD_COLOR)
    if image is None:
        raise RuntimeError(f"OpenCV cannot decode {image_path}")
    out = out or frames_path(image_path)
    tmp = out + ".tmp.npz"
    np.savez_compressed(
        tmp, frames=cv2.cvtColor(image, cv2.COLOR_BGR2RGB)[None].astype(
            np.uint8), fps=np.float64(0.0))
    os.replace(tmp, out)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="a clip, or an image")
    ap.add_argument("--out", default="",
                    help="output file (default: <stem>.frames.npz beside "
                         "the input)")
    args = ap.parse_args(argv)
    image = os.path.splitext(args.path)[1].lower() in IMAGE_EXTENSIONS
    print((decode_image if image else decode_frames)(args.path, args.out))


if __name__ == "__main__":
    main()
