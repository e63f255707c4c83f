"""How much a checkpoint save in flight slows the paper f32 train step, by part of the save.

    python3 tools/checkpoint_overlap.py        # needs one CUDA GPU (builds the kernels)

The paper segmentation config (``heal_swin_torch.run_configs.paper_swin_hp_config``: f32,
dropout, attention dropout and DropPath 0.1; nside 256, batch 2, Adam) takes train steps
with a synchronize after each (as ``Trainer.fit`` does when it logs every step's loss),
while a background thread runs one part of ``CheckpointManager``'s save of the model's
and the optimizer's state (~0.46 GiB):

- ``none``: no save (the control);
- ``d2h``: the device snapshot's copy to pageable host memory on a side stream;
- ``d2h_pinned``: the same into pinned buffers, ``non_blocking``, one synchronize;
- ``write_path``: ``torch.save`` of host tensors to a path;
- ``write_file``: ``torch.save`` of host tensors to an open file object;
- ``save``: the manager's whole save (``save_epoch`` then ``flush``);
- ``save_pageable``: the same with the host copy to pageable memory (``t.cpu()`` on the
  side stream), the manager's first form.

Each variant runs STEPS steps from the save's start, in turns (the list, then reversed,
ROUNDS times); printed: every step's ms, each variant's median step ms over the turns,
the extra ms its steps took over the control's, and the save part's own seconds.  The
last line is a JSON object of the medians.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

NSIDE = 256
BATCH = 2
STEPS = 6
ROUNDS = 2
VARIANTS = ("none", "d2h", "d2h_pinned", "write_path", "write_file", "save", "save_pageable")


def main() -> int:
    if not torch.cuda.is_available():
        print("checkpoint_overlap: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    from heal_swin_torch import _build
    from heal_swin_torch.models import tasks as T
    from heal_swin_torch.models.swin_hp import DataSpec
    from heal_swin_torch.run_configs import PAPER_LR, paper_swin_hp_config
    from heal_swin_torch.training import checkpoint as ckpt
    from heal_swin_torch.training.optimizer import OptimizerConfig, make_optimizer
    from heal_swin_torch.training.trainer import step_generator, train_step

    _build.lib()
    dev = torch.device("cuda", 0)
    npix = 8 * NSIDE * NSIDE
    task = T.WoodscapeSegmenterSwinHP(
        T.WoodscapeSegmenterSwinHPConfig(paper_swin_hp_config(),
                                         optimizer_config=OptimizerConfig(learning_rate=PAPER_LR)),
        DataSpec(dim_in=npix, f_in=3, f_out=4, base_pix=8), device=dev)
    opt = make_optimizer(task.model.parameters(), task.optimizer_config)
    gen = torch.Generator().manual_seed(0)
    imgs = torch.randn(BATCH, npix, 3, generator=gen).to(dev)
    targets = torch.randint(0, 4, (BATCH, npix), generator=gen).to(dev, torch.int32)
    mstate = task.metric_init()
    step = [0]

    def one_step():
        nonlocal mstate
        loss, mstate = train_step(task, opt, mstate, imgs, targets,
                                  step_generator(0, step[0], dev))
        step[0] += 1
        float(loss)

    for _ in range(3):
        one_step()
    root = Path(tempfile.mkdtemp(prefix="ckpt_overlap_"))
    side = torch.cuda.Stream(dev)

    def state():
        return task.model.state_dict(), opt.state_dict()

    def host_state():
        return ckpt._tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t, state())

    class Pageable(ckpt.CheckpointManager):
        def _to_host(self, state, event):
            with torch.cuda.stream(side):
                side.wait_event(event)
                host = ckpt._tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t,
                                      state)
            side.synchronize()
            return host

    def job(kind, n):
        t0 = time.perf_counter()
        if kind == "d2h" or kind == "d2h_pinned":
            snap, event = ckpt._snapshot(state())
            with torch.cuda.stream(side):
                side.wait_event(event)
                if kind == "d2h":
                    ckpt._tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t, snap)
                else:
                    ckpt._tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                                   .copy_(t, non_blocking=True)
                                   if isinstance(t, torch.Tensor) else t, snap)
            side.synchronize()
        elif kind == "write_path":
            torch.save(ckpt._payload(*host, {}), root / f"p{n}.ckpt")
        elif kind == "write_file":
            with open(root / f"f{n}.ckpt", "wb") as f:
                torch.save(ckpt._payload(*host, {}), f)
        part_s[kind].append(time.perf_counter() - t0)

    host = host_state()
    steps_ms = {k: [] for k in VARIANTS}
    part_s = {k: [] for k in VARIANTS}
    order = [v for _ in range(ROUNDS) for v in (VARIANTS + VARIANTS[::-1])]
    for n, kind in enumerate(order):
        torch.cuda.synchronize()
        if kind.startswith("save"):
            cls = ckpt.CheckpointManager if kind == "save" else Pageable
            mgr = cls(root / f"m{n}", monitor="m")
            mgr.save_epoch(0, {"m": 0.0}, *state(), {})
            th = threading.Thread(target=mgr.flush)
        else:
            th = threading.Thread(target=job, args=(kind, n))
        th.start()
        ms = []
        for _ in range(STEPS):
            ts = time.perf_counter()
            one_step()
            ms.append((time.perf_counter() - ts) * 1e3)
        th.join()
        if kind.startswith("save"):
            part_s[kind].append(mgr.save_seconds)
        steps_ms[kind].append(ms)
        print(f"turn {n} {kind}: step ms " + " ".join(f"{v:.1f}" for v in ms), flush=True)
    ckpt_bytes = os.path.getsize(next(root.glob("p*.ckpt")))
    shutil.rmtree(root)
    control = statistics.median(v for r in steps_ms["none"] for v in r)
    out = {}
    for kind in VARIANTS:
        flat = [v for r in steps_ms[kind] for v in r]
        extra = statistics.median(sum(v - control for v in r) for r in steps_ms[kind])
        out[kind] = dict(median_step_ms=statistics.median(flat), extra_ms_over_the_steps=extra,
                         part_s=statistics.median(part_s[kind]) if part_s[kind] else None)
        print(f"{kind}: median step {out[kind]['median_step_ms']:.2f} ms, extra over "
              f"{STEPS} steps {extra:.1f} ms (control median {control:.2f}), part "
              f"{out[kind]['part_s']}")
    print(json.dumps({"checkpoint_overlap": out, "device": torch.cuda.get_device_name(0),
                      "checkpoint_bytes": ckpt_bytes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
