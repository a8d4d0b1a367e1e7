"""Writes the title strips in ``tests/data/text``: OpenCV 5.0's
``cv2.putText(strip, name, (6, 18), FONT_HERSHEY_SIMPLEX, 0.5,
(255, 255, 0), 1, LINE_AA)``, the call the JAX package's
``CompareFramesReader`` makes, on 24 x 160 RGB strips. They are the
oracle that ``chip_smoke.phase_compare_frames`` holds the port's
``CompareFramesReader`` titles against without importing cv2;
``tests/test_torch_port_compare.py`` holds them against a fresh cv2
render.

* ``on_frame_<k>.png``: the top-left 24 x 160 of the evaluation phase's
  first frame (``portbench.traffic.panning_background`` from seed 30,
  ``chip_smoke.square_clip(seed=30)``'s frames), titled with
  each name the phase draws;
* ``on_black_<k>.png``: black, titled with those names and some of the
  CPU tests' titles (a coverage map: red and green hold it, blue is 0).

``titles.json`` maps each file to its title. Needs cv2:

    PYTHONPATH=. python tests/data/text/make_text_fixtures.py
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
STRIP = (24, 160)
ORG = (6, 18)
COLOR = (255, 255, 0)
PHASE_NAMES = ("v0", "frames")
BLACK_NAMES = PHASE_NAMES + ("davis_gt", "bmx-trees", "FGT (ours)",
                             "result_0001", "AV To", "Über")


def first_frame_strip() -> np.ndarray:
    """The top-left strip of the evaluation phase's first frame."""
    sys.path.insert(0, REPO)
    from portbench.traffic import panning_background

    frames = panning_background(np.random.RandomState(30), 24, 240, 432, 2)
    return frames[0, :STRIP[0], :STRIP[1]].copy()


def cv2_title(background: np.ndarray, name: str) -> np.ndarray:
    import cv2

    img = np.ascontiguousarray(background).copy()
    cv2.putText(img, name, ORG, cv2.FONT_HERSHEY_SIMPLEX, 0.5, COLOR, 1,
                cv2.LINE_AA)
    return img


def renders() -> dict:
    """{file name: (title, RGB strip)} of every fixture."""
    frame = first_frame_strip()
    black = np.zeros(STRIP + (3,), np.uint8)
    out = {}
    for k, name in enumerate(PHASE_NAMES):
        out[f"on_frame_{k}.png"] = (name, cv2_title(frame, name))
    for k, name in enumerate(BLACK_NAMES):
        out[f"on_black_{k}.png"] = (name, cv2_title(black, name))
    return out


def main() -> None:
    sys.path.insert(0, REPO)
    from fgt_tpu_torch.pipeline import image_io

    titles = {}
    for fname, (name, img) in renders().items():
        image_io.write_png(os.path.join(HERE, fname), img)
        titles[fname] = name
    with open(os.path.join(HERE, "titles.json"), "w") as f:
        json.dump(titles, f, indent=1, ensure_ascii=False)
        f.write("\n")
    print(f"{len(titles)} strips in {HERE}")


if __name__ == "__main__":
    main()
