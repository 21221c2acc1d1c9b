"""Decode a clip once into the frames file the port's dataset reads.

    python -m hpvaegan_tpu_torch.tools.decode_frames data/vids/wingsuit.avi

writes ``data/vids/wingsuit.frames.npz`` beside the clip: ``frames``
(N, H, W, 3) uint8 RGB at the clip's own size, every frame, and ``fps``.
It does what ``video_to_frames`` (``hpvaegan_tpu/data/video.py:26-56``)
does up to the resize: OpenCV's decode, BGR -> RGB, the 500-null-read
guard.  The per-scale resize happens in the dataset
(``hpvaegan_tpu_torch/data/video.py``), which needs no OpenCV, so a clip
decoded here trains on a machine without it.

This is the port's only module that imports ``cv2``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

__all__ = ["frames_path", "decode_frames"]


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("video_path")
    ap.add_argument("--out", default="",
                    help="output file (default: <clip stem>.frames.npz "
                         "beside the clip)")
    args = ap.parse_args(argv)
    print(decode_frames(args.video_path, args.out))


if __name__ == "__main__":
    main()
