"""The flat SWIN-UNet's phases of ``chip_smoke.py`` alone, on the card.

    python3 tools/flat_phases.py [bf16] [paper] [entry]   # needs one CUDA GPU

Builds the kernels, then runs the named phases (all three by default) as
``chip_smoke.py`` runs them: ``bf16`` its ``drive_flat`` (the flat kernels against their
plain versions, bench.py's ``swin`` / ``depth_swin`` predict and train steps through both
paths), ``paper`` its ``drive_flat_paper`` (the paper flat configs in f32: the f32
kernels at the flat shapes, the train step, predict against ``attention_impl="xla"``,
``Trainer.fit`` with a resume), ``entry`` its ``drive_flat_entry`` (``cli train`` and
``cli evaluate`` of the paper flat segmentation config on a generated 966 x 1280 WoodScape
fixture, the headline writer against the plain route, the flat depth Chamfer writer), in
a temporary ``HEAL_SWIN_DATA_ROOT`` whose fixtures this script generates.  Without
``paper`` the entry phase first holds the f32 window-attention and f32 tail kernels at
the flat shapes, so that the shapes it launches at are checked ones.  Every check
raises on a failure; the last line says ``flat phases done``.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def main(which):
    if not torch.cuda.is_available():
        print("flat_phases: no CUDA device", file=sys.stderr)
        return 1
    from heal_swin_torch import _build
    from heal_swin_torch.data.synthetic_woodscape import generate

    c.log(c.nvidia_smi())
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: full f32 products
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.lib()
    c.log(f"build {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    timed = {}
    if "bf16" in which:
        t = time.perf_counter()
        c.drive_flat(dev, timed)
        c.log(f"drive_flat {time.perf_counter() - t:.1f} s")
    if "paper" in which:
        t = time.perf_counter()
        c.drive_flat_paper(dev, timed)
        c.log(f"drive_flat_paper {time.perf_counter() - t:.1f} s")
    if "entry" in which:
        if "paper" not in which:
            from heal_swin_torch.ops import final_head as fh

            timed.update(c.check_f32_eval_kernels(torch.Generator().manual_seed(1), dev,
                                                  flat=True))
            timed.update(c.check_f32_loss_kernels(c.paper_tail_inputs(
                torch.Generator().manual_seed(2), dev, flat=True), fh))
        t = time.perf_counter()
        with c.entry_world() as root:
            for version, depth in (("woodscape", False), ("synwoodscape", True)):
                generate(root, version=version, n_per_cam=c.RUN_N_PER_CAM, W=c.FIXTURE_W,
                         H=c.FIXTURE_H, seed=0, with_depth=depth)
            c.drive_flat_entry(dev, timed, root)
        c.log(f"drive_flat_entry {time.perf_counter() - t:.1f} s")
    c.log("flat phases done")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["bf16", "paper", "entry"]))
