"""Run configs for the port's entry points (``python3 -m heal_swin_torch.cli train
--config_path heal_swin_torch/configs/<file>``): the port's copies of the JAX package's
hardware smoke configs, importing only ``heal_swin_torch``."""
