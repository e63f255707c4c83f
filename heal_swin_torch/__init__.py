"""heal-swin-torch: the PyTorch/CUDA port of heal-swin-tpu for NVIDIA Hopper GPUs.

The module layout mirrors ``heal_swin_tpu``: ``ops/`` holds the token operations and
the hand-written CUDA kernels (with their plain PyTorch versions), ``models/`` the
HEAL-SWIN-UNet and its segmentation task, ``convert.py`` the JAX-params-to-state_dict
map.  The port imports torch and never jax; the numpy host code it shares with the
JAX package (HEALPix geometry, shift specs, data specs) is imported from there.
"""

__version__ = "0.1.0"
