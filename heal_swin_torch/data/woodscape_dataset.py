"""Base WoodScape file-listing dataset (reference heal_swin/data/woodscape_dataset.py).

Scans a directory by extension, buckets by camera position (FV/RV/MVL/MVR filename
substrings), deterministic RandomState(42) shuffle after sorting, train/val split by
``train_share`` slicing, optional training-fraction subset with its own seed.  The
port's copy of ``heal_swin_tpu/data/woodscape_dataset.py``."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class WoodscapeDataset:
    def __init__(
        self,
        cam_pos: Optional[str] = None,
        train_share: float = 0.8,
        part: str = "train",
        padding=(0, 0, 0, 0),
        shuffle_train_val_split: bool = True,
        woodscape_version: Optional[str] = None,
        training_data_fraction: float = 1.0,
        data_fraction_seed: int = 42,
    ):
        self.woodscape_version = woodscape_version
        paths_dict = self.get_paths()

        if cam_pos is None:
            paths = []
            for p in paths_dict.values():
                paths += list(p)
        elif cam_pos in paths_dict:
            paths = list(paths_dict[cam_pos])
        else:
            raise ValueError(f"camera position {cam_pos} unknown")
        self.paths = paths

        self._shuffle_paths(shuffle_train_val_split)

        assert 0 <= train_share <= 1
        if part == "train":
            min_idx, max_idx = 0, int(np.floor(len(self.paths) * train_share))
        elif part == "val":
            min_idx, max_idx = int(np.ceil(len(self.paths) * train_share)), len(self.paths) - 1
        else:
            raise ValueError(f"Unknown part {part}, set to 'train' or 'val'")
        self.paths = list(self.paths[min_idx : max_idx + 1])
        if part == "train":
            self._take_subset(training_data_fraction, data_fraction_seed)

        self.update_paths()

    # -- overridables -------------------------------------------------------
    def get_dir(self):
        raise NotImplementedError

    def get_extension(self):
        return ".png"

    # -- internals -----------------------------------------------------------
    def get_paths(self):
        root_dir = self.get_dir()
        if not os.path.isdir(root_dir):
            raise FileNotFoundError(f"Could not find directory at {root_dir}")
        ext = self.get_extension()
        entries = [e.path for e in os.scandir(root_dir) if ext in e.name]
        return {
            "fv": [p for p in entries if "FV" in p],
            "rv": [p for p in entries if "RV" in p],
            "mvl": [p for p in entries if "MVL" in p],
            "mvr": [p for p in entries if "MVR" in p],
        }

    def _shuffle_paths(self, shuffle):
        self.paths.sort()
        if shuffle:
            r = np.random.RandomState(42)
            self.paths = list(np.array(self.paths)[r.permutation(len(self.paths))])

    def _take_subset(self, fraction, seed):
        r = np.random.RandomState(seed)
        n = int(np.ceil(len(self.paths) * fraction))
        self.paths = list(np.array(self.paths)[r.permutation(len(self.paths))][:n])

    def update_paths(self):
        for p in self.paths:
            if not os.path.isfile(p):
                raise FileNotFoundError(f"Could not find file {p}")
        self.file_names = np.array([os.path.basename(p) for p in self.paths])

    def __len__(self):
        return len(self.paths)
