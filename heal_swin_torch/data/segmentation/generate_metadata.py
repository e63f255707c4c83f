"""Calibration-cluster metadata of a WoodScape dataset (the port's copy of
``get_cal_distributions`` and ``gen_cal_distribution_data`` in
``heal_swin_tpu/data/segmentation/generate_metadata.py``; reference
``heal_swin/data/segmentation/generate_metadata.py:156-210``).

``{pos}_samples_by_cal_data.pickle`` holds, for one camera position, a list of
``{"cal_info": dict, "file_names": numpy str array}``: the samples grouped by identical
intrinsic calibration, which the HP-masked IoU writers score cluster by cluster.  The
files hold plain dicts and numpy arrays only, so either package reads the other's.
The class legend (matplotlib) and the dataset overview stay with the JAX package."""

from __future__ import annotations

import os
import pickle

import numpy as np

from heal_swin_torch.data.segmentation import flat_datasets
from heal_swin_torch.utils.utils import get_datasets_path

_CAL_FIELDS = [
    "aspect_ratio", "cx_offset", "cy_offset", "height",
    "k1", "k2", "k3", "k4", "poly_order", "width",
]


def get_cal_distributions(pos, path, woodscape_version):
    """Cluster samples by identical intrinsic calibration; pickle
    [{cal_info, file_names}] (reference :156-210)."""
    cal_dataset = flat_datasets.WoodscapeCalibrationDataset(
        cam_pos=pos, train_share=1.0, part="train", woodscape_version=woodscape_version
    )
    data = np.zeros((len(cal_dataset), len(_CAL_FIELDS)))
    for idx in range(len(cal_dataset)):
        intr = cal_dataset[idx]["intrinsic"]
        data[idx] = [intr[f] for f in _CAL_FIELDS]
    unique, u_idcs, u_inverse, u_counts = np.unique(
        data, axis=0, return_counts=True, return_index=True, return_inverse=True
    )
    print(f"Unique calibration data of {pos} dataset: {len(unique)} different calibrations")

    samples_by_cal_data = []
    for i in range(len(unique)):
        cal_info = cal_dataset[int(u_idcs[i])]
        cal_info.pop("file_name", None)
        names = np.asarray(cal_dataset.paths)[np.where(u_inverse == i)]
        names = np.array([os.path.splitext(os.path.basename(n))[0] for n in names])
        assert len(names) == u_counts[i]
        samples_by_cal_data.append({"cal_info": cal_info, "file_names": names})

    with open(path, "wb") as f:
        pickle.dump(samples_by_cal_data, f)


def gen_cal_distribution_data(woodscape_version):
    for pos in ["fv", "rv", "mvr", "mvl"]:
        path = os.path.join(
            get_datasets_path() / woodscape_version, f"{pos}_samples_by_cal_data.pickle"
        )
        if not os.path.isfile(path):
            get_cal_distributions(pos, path, woodscape_version)
