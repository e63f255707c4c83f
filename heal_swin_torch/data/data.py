"""Data dispatch: data config -> (datamodule, data spec) (the port's counterpart of
``heal_swin_tpu/data/data.py``).

The port has the synthetic HEALPix datamodules (``version="synthetic"``); the real
WoodScape / SynWoodScape datamodules and the flat configs raise until the port's data
path has them.
"""

from __future__ import annotations

from heal_swin_torch.data import normalize_depth_data as ndd
from heal_swin_torch.data.data_spec import DataSpec, DepthDataSpec


def create_dataspec_from_data_module(dm, base_pix=0) -> DataSpec:
    """Reference data_spec.py:14-22."""
    f_in = dm.get_img_features() if dm.get_img_features() > 2 else 1
    return DataSpec(f_in=f_in, f_out=dm.get_classes(), dim_in=dm.get_img_dims(),
                    base_pix=base_pix, class_names=dm.get_class_names())


def create_depth_dataspec_from_data_module(dm, base_pix, data_config) -> DepthDataSpec:
    """Reference data_spec_depth.py:17-51: with the dataset statistics of the
    configured transform space."""
    dc = data_config.common_depth
    f_in = dm.get_img_features() if dm.get_img_features() > 2 else 1
    return DepthDataSpec(f_in=f_in, f_out=1, dim_in=dm.get_img_dims(), base_pix=base_pix,
                         class_names=dm.get_class_names(),
                         data_stats=ndd.get_depth_data_stats(dc.data_transform,
                                                             dc.mask_background))


def get_data_module(data_config):
    """(datamodule, data spec) of a ``WoodscapeHPConfig`` or ``WoodscapeHPDepthConfig``
    with ``common.version == "synthetic"``."""
    from heal_swin_torch.data import synthetic

    name = type(data_config).__name__
    if name not in ("WoodscapeHPConfig", "WoodscapeHPDepthConfig"):
        raise NotImplementedError(f"data config {name}: the port's flat datamodules come "
                                  "with its flat SWIN-UNet (ROADMAP queue 1 item 5)")
    if data_config.common.version != "synthetic":
        raise NotImplementedError(
            f"data version {data_config.common.version!r}: the port's WoodScape datamodules "
            "come with its data path (ROADMAP queue 1 item 3b); version='synthetic' runs")
    bp = data_config.input_base_pix
    if name == "WoodscapeHPConfig":
        dm = synthetic.SyntheticHPSegDataModule(data_config)
        return dm, create_dataspec_from_data_module(dm, base_pix=bp)
    dm = synthetic.SyntheticHPDepthDataModule(data_config)
    return dm, create_depth_dataspec_from_data_module(dm, bp, data_config)
