"""Data dispatch: data config -> (datamodule, data spec) (the port's counterpart of
``heal_swin_tpu/data/data.py``).

``version="synthetic"`` routes to the in-memory synthetic datamodules; the woodscape
versions route to the real WoodScape / SynWoodScape datamodules, HEALPix or flat.
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


def get_hp_data_module(config):
    if config.common.version == "synthetic":
        from heal_swin_torch.data.synthetic import SyntheticHPSegDataModule

        dm = SyntheticHPSegDataModule(config)
    else:
        from heal_swin_torch.data.segmentation.hp_datamodule import (
            WoodscapeHPSegmentationDataModule,
        )

        dm = WoodscapeHPSegmentationDataModule(config)
    return dm, create_dataspec_from_data_module(dm, base_pix=config.input_base_pix)


def get_flat_data_module(config):
    if config.common.version == "synthetic":
        from heal_swin_torch.data.synthetic import SyntheticFlatSegDataModule

        dm = SyntheticFlatSegDataModule(config)
    else:
        from heal_swin_torch.data.segmentation.flat_datamodule import (
            WoodscapeFlatSegmentationDataModule,
        )

        dm = WoodscapeFlatSegmentationDataModule(config)
    return dm, create_dataspec_from_data_module(dm)


def get_depth_hp_data_module(config):
    if config.common.version == "synthetic":
        from heal_swin_torch.data.synthetic import SyntheticHPDepthDataModule

        dm = SyntheticHPDepthDataModule(config)
    else:
        from heal_swin_torch.data.depth_estimation.hp_depth_datamodule import (
            WoodscapeHPDepthDataModule,
        )

        dm = WoodscapeHPDepthDataModule(config)
    return dm, create_depth_dataspec_from_data_module(dm, config.input_base_pix, config)


def get_depth_flat_data_module(config):
    if config.common.version == "synthetic":
        from heal_swin_torch.data.synthetic import SyntheticFlatDepthDataModule

        dm = SyntheticFlatDepthDataModule(config)
    else:
        from heal_swin_torch.data.depth_estimation.flat_depth_datamodule import (
            WoodscapeFlatDepthDataModule,
        )

        dm = WoodscapeFlatDepthDataModule(config)
    return dm, create_depth_dataspec_from_data_module(dm, config.base_pix, config)


_DISPATCH = {
    "WoodscapeHPConfig": get_hp_data_module,
    "WoodscapeFlatConfig": get_flat_data_module,
    "WoodscapeHPDepthConfig": get_depth_hp_data_module,
    "WoodscapeDepthFlatConfig": get_depth_flat_data_module,
}


def get_data_module(data_config):
    """(datamodule, data spec) of a data config, dispatched on its class name
    (reference data.py:76-83)."""
    name = type(data_config).__name__
    if name not in _DISPATCH:
        raise ValueError(f"unknown data config class: {name}")
    return _DISPATCH[name](data_config)
