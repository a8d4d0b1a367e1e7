"""Dataset-preparation reader library — counterpart of
``fgt_tpu/data/readers.py`` (the reference's aux reader zoo,
``FGT/data/util/readers.py:20-527``): directory-backed frame and mask
readers with sampling and max-length truncation, bounding boxes from
masks, bbox-list mask generation, and frame and video writers.

Every reader yields [H, W, 3] uint8 RGB frames or [H, W] uint8 masks
(255 = hole) read as the JAX package's ``cv2.imread`` reads them
(``pipeline.image_io.imread``: EXIF orientation applied, gray masks
through libpng's and libjpeg's own gray conversions); resizes are cv2's
``INTER_LINEAR`` (``image_io.resize_linear_u8``); boxes come from
``core.raster.external_bboxes``, in cv2's order. Frames are saved as PNG
and videos as Motion-JPEG AVIs (``core.video_io.write_avi``), as the
JAX package's cv2 writes them. ``CompareFramesReader``'s column titles
are drawn by ``core.text``, bit-equal to the JAX package's
``cv2.putText(..., FONT_HERSHEY_SIMPLEX, 0.5, ..., LINE_AA)``.
"""

from __future__ import annotations

import glob as _glob
import logging
import os

import numpy as np

from fgt_tpu_torch.core import raster, text, video_io
from fgt_tpu_torch.pipeline import image_io

logger = logging.getLogger("fgt_tpu_torch")

DEFAULT_FPS = 6
MAX_LENGTH = 60


class Reader:
    """Directory-backed sequence with ``[::sample_period][:max_length]``
    truncation, list/iterator protocol, and per-file save
    (reference readers.py:92-160)."""

    def __init__(self, dir_name: str | None, read: bool = True,
                 max_length: int | None = None, sample_period: int = 1):
        self.dir_name = dir_name
        self.max_length = max_length
        self.sample_period = sample_period
        self.filenames: list[str] = []
        self.files: list = []
        if read and dir_name:
            if os.path.exists(dir_name):
                names = sorted(_glob.glob(os.path.join(dir_name, "*")))
                names = [f for f in names if os.path.isfile(f)]
                self.filenames = names[::sample_period][:max_length]
                self.files = [self.read_file(f) for f in self.filenames]
            else:
                logger.warning("Directory %s not exists!", dir_name)

    def append(self, file_):
        self.files.append(file_)

    def set_files(self, files):
        self.files = list(files)

    def read_file(self, filename):
        raise NotImplementedError

    def _save_file(self, output_dir, i, file_):
        raise NotImplementedError

    def save_files(self, output_dir):
        os.makedirs(output_dir, exist_ok=True)
        for i, f in enumerate(self.files):
            self._save_file(output_dir, i, f)

    def __iter__(self):
        return iter(self.files)

    def __getitem__(self, key):
        return self.files[key]

    def __len__(self):
        return len(self.files)


class FrameReader(Reader):
    """RGB uint8 frames, optional (w, h) resize and scale
    (reference readers.py:162-207)."""

    def __init__(self, dir_name, resize=None, read=True,
                 max_length=MAX_LENGTH, scale: float = 1,
                 sample_period: int = 1):
        self.resize = resize
        self.scale = scale
        super().__init__(dir_name, read, max_length, sample_period)

    def read_file(self, filename):
        img = image_io.imread(filename, "color")
        h, w = img.shape[:2]
        size = self.resize if self.resize is not None else (w, h)
        tw, th = int(size[0] * self.scale), int(size[1] * self.scale)
        if (tw, th) != (w, h):
            img = image_io.resize_linear_u8(img, th, tw)
        return img

    def _save_file(self, output_dir, i, file_):
        if len(self.filenames) == len(self.files):
            name = os.path.basename(sorted(self.filenames)[i])
            name = os.path.splitext(name)[0] + ".png"
        else:
            name = f"frame_{i:04}.png"
        image_io.write_png(os.path.join(output_dir, name), file_)

    def write_files_to_video(self, output_filename, fps: int = DEFAULT_FPS,
                             frame_num_when_repeat_list=(1,)):
        """Every frame, each repeated ``rep`` times, once for each ``rep``
        of ``frame_num_when_repeat_list``, as a Motion-JPEG AVI (under
        whatever name it is given, as cv2's ``MJPG`` writer does)."""
        frames = [frame for rep in frame_num_when_repeat_list
                  for frame in self.files for _ in range(rep)]
        video_io.write_avi(output_filename, frames, fps)


class SegmentationReader(FrameReader):
    """Binarizes segmentation PNGs into hole masks: any nonzero pixel ->
    255 (reference readers.py:289-307 thresholds at 1)."""

    def read_file(self, filename):
        img = image_io.imread(filename, "gray")
        return ((img > 0) * 255).astype(np.uint8)

    def _save_file(self, output_dir, i, file_):
        image_io.write_png(os.path.join(output_dir, f"segm_{i:04}.png"),
                           file_)


class MaskReader(Reader):
    """Grayscale masks (255 = hole) + bounding boxes of their external
    contours (reference readers.py:309-351)."""

    def __init__(self, dir_name, read=True):
        super().__init__(dir_name, read=read)

    def read_file(self, filename):
        return image_io.imread(filename, "gray")

    def _save_file(self, output_dir, i, file_):
        image_io.write_png(os.path.join(output_dir, f"mask_{i:04}.png"),
                           file_)

    def get_bboxes(self, i):
        """[((x0, y0), (x1, y1))] inclusive corners of each outermost
        8-connected component of mask ``i`` > 127, in cv2's order."""
        mask = np.asarray(self.files[i]) > 127
        return [((x, y), (x + w - 1, y + h - 1))
                for x, y, w, h in raster.external_bboxes(mask)]

    def get_bbox(self, i):
        boxes = self.get_bboxes(i)
        return boxes[0] if boxes else None


class MaskGenerator(Reader):
    """Rasterizes per-frame bbox lists into hole masks and (optionally)
    saves them (reference readers.py:353-391)."""

    def __init__(self, mask_output_dir, size, bboxeses, save_masks=True):
        self.bboxeses = bboxeses
        self.size = size  # (w, h)
        super().__init__(mask_output_dir, read=False)
        self.files = [self.generate_mask(i) for i in range(len(bboxeses))]
        if save_masks:
            self.save_files(mask_output_dir)

    def _save_file(self, output_dir, i, file_):
        image_io.write_png(os.path.join(output_dir, f"mask_{i:04}.png"),
                           file_)

    def get_bboxes(self, i):
        return self.bboxeses[i]

    def generate_mask(self, i):
        w, h = self.size
        mask = np.zeros((h, w), np.uint8)
        for (x0, y0), (x1, y1) in self.bboxeses[i]:
            mask[y0:y1 + 1, x0:x1 + 1] = 255
        return mask


class CompareFramesReader(Reader):
    """Side-by-side comparison canvases from N frame directories, each
    tile titled with its name at (6, 18) in yellow, ``col`` tiles a row,
    short rows padded on the right with black (reference
    readers.py:431-485 evaluation collage). Each title is rasterised
    once; a canvas costs a blend a tile."""

    TITLE_ORG = (6, 18)
    TITLE_COLOR = (255, 255, 0)

    def __init__(self, dir_names, col: int | None = None, names=(),
                 mask_dir=None):
        self.readers = [FrameReader(d) for d in dir_names]
        self.names = list(names) or [os.path.basename(d.rstrip("/"))
                                     for d in dir_names]
        self.col = col or len(self.readers)
        self.titles = [text.render_text(name) for name in self.names]
        super().__init__(None, read=False)
        n = min(len(r) for r in self.readers)
        self.files = [self._canvas(i) for i in range(n)]

    def _canvas(self, i):
        tiles = [title.draw(reader[i].copy(), self.TITLE_ORG,
                            self.TITLE_COLOR)
                 for title, reader in zip(self.titles, self.readers)]
        rows = [np.concatenate(tiles[r:r + self.col], axis=1)
                for r in range(0, len(tiles), self.col)]
        width = max(r.shape[1] for r in rows)
        rows = [np.pad(r, ((0, 0), (0, width - r.shape[1]), (0, 0)))
                for r in rows]
        return np.concatenate(rows, axis=0)

    def _save_file(self, output_dir, i, file_):
        image_io.write_png(os.path.join(output_dir, f"compare_{i:04}.png"),
                           file_)


class BoundingBoxesListReader(Reader):
    """Reads per-frame bbox lists from ``*.txt`` files, one
    ``x0 y0 x1 y1`` per line (reference readers.py:487-500)."""

    def __init__(self, dir_name, read=True, max_length=None,
                 sample_period=1):
        super().__init__(dir_name, read, max_length, sample_period)

    def read_file(self, filename):
        boxes = []
        with open(filename) as f:
            for line in f:
                vals = [int(v) for v in line.split()]
                if len(vals) == 4:
                    boxes.append(((vals[0], vals[1]), (vals[2], vals[3])))
        return boxes

    def _save_file(self, output_dir, i, file_):
        with open(os.path.join(output_dir, f"bboxes_{i:04}.txt"), "w") as f:
            for (x0, y0), (x1, y1) in file_:
                f.write(f"{x0} {y0} {x1} {y1}\n")


def save_frames_to_dir(frames, dirname):
    """reference readers.py:502-506."""
    reader = FrameReader(dirname, read=False)
    reader.set_files(frames)
    reader.save_files(dirname)
