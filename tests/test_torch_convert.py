"""heal_swin_torch's JAX-params converter against the flax-path -> torch-key map the
JAX package was pinned with (``tests/reference_oracle.py:_map_hp_path``), and the
port's independence from JAX."""

import os
import subprocess
import sys
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from heal_swin_torch.convert import state_dict_from_flax
from heal_swin_torch.models import swin_hp as tsh
from heal_swin_tpu.data.data_spec import DataSpec
from heal_swin_tpu.models import swin_hp as jsh
from tests.reference_oracle import _map_hp_path

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("v2,ape,embed_norm", [(True, False, None), (False, True, "LayerNorm")])
def test_every_flax_leaf_maps_to_one_port_key(v2, ape, embed_norm):
    kw = dict(patch_size=4, window_size=16, shift_size=8, shift_strategy="ring_shift",
              rel_pos_bias="flat", embed_dim=8, depths=[2, 1], num_heads=[2, 2],
              use_cos_attn=True, use_v2_norm_placement=v2, ape=ape,
              patch_embed_norm_layer=embed_norm)
    spec = DataSpec(dim_in=512, f_in=3, f_out=5, base_pix=8)
    jmodel = jsh.SwinHPTransformerSys(jsh.SwinHPTransformerConfig(**kw), spec)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, 512, 3)), True)
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
    flat = flax.traverse_util.flatten_dict(params["params"], sep="/")

    sd = state_dict_from_flax(params)
    assert len(sd) == len(flat)
    for path, value in flat.items():
        key, to_flax = _map_hp_path(path)
        assert key in sd, (path, key)
        np.testing.assert_array_equal(to_flax(sd[key].numpy()), value, err_msg=path)

    port = tsh.SwinHPTransformerSys(tsh.SwinHPTransformerConfig(**kw), spec, device="cpu")
    assert set(port.state_dict()) == set(sd)
    port.load_state_dict(sd, strict=True)
    for k, v in port.state_dict().items():
        assert tuple(v.shape) == tuple(sd[k].shape), k


def test_port_imports_without_jax():
    """The port's modules import with jax unavailable (the GPU host has none)."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['flax'] = None\n"
            "import heal_swin_torch, heal_swin_torch.convert, heal_swin_torch._build\n"
            "import heal_swin_torch.models.tasks, heal_swin_torch.ops.final_head\n"
            "assert 'jax.numpy' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
