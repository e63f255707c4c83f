"""Data specifications passed from the data layer to model constructors (the port's
copy of ``heal_swin_tpu/data/data_spec.py``).

Mirrors reference ``heal_swin/data/segmentation/data_spec.py:5-22`` and
``heal_swin/data/depth_estimation/data_spec_depth.py:17-51``.  ``dim_in`` is the pixel
count for HEALPix models and (H, W) for flat models.  The port's models take
channels-last inputs: (B, N, f_in) / (B, H, W, f_in).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, List, Optional, Tuple, Union


@dataclass
class DataSpec:
    dim_in: Union[int, Tuple[int, int]]
    f_in: int
    f_out: int
    base_pix: int = 8
    class_names: Optional[List[str]] = None

    def replace(self, **kwargs) -> "DataSpec":
        return replace(self, **kwargs)


@dataclass
class DepthDataSpec:
    dim_in: Union[int, Tuple[int, int]]
    f_in: int
    f_out: int
    base_pix: int = 8
    class_names: Optional[List[str]] = None
    data_stats: Any = None  # normalize_depth_data.DataStats

    def replace(self, **kwargs) -> "DepthDataSpec":
        return replace(self, **kwargs)
