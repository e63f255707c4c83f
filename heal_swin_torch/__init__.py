"""heal-swin-torch: the PyTorch/CUDA port of heal-swin-tpu for NVIDIA Hopper GPUs.

The module layout mirrors ``heal_swin_tpu``: ``ops/`` holds the token operations, the
HEALPix geometry and the hand-written CUDA kernels (with their plain PyTorch
versions), ``models/`` the HEAL-SWIN-UNet and its segmentation and depth tasks,
``evaluation/`` the metrics and the Chamfer prediction writer, ``projection/`` and
``utils/`` the fisheye camera model and depth point clouds, ``convert.py`` the
JAX-params-to-state_dict map.  The port imports torch and never jax, and nothing of
the JAX package: the numpy host code it needs from there (HEALPix geometry, shift
specs, data specs and configs, the camera model) is its own copy.  Its entry points
run on the first CUDA device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
