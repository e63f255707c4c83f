"""Where the time of the bf16 fit through the real input path goes, on the card.

    python3 tools/real_path_timing.py        # needs one CUDA GPU (builds the kernels)

The port's convergence config (``heal_swin_torch/configs/smoke_convergence_run_config.py``:
the bf16 paper model, nside 256, batch 2, ``project_on_device``) on a generated 966 x 1280
WoodScape fixture (``N_PER_CAM`` images a camera: 13 train samples, 6 steps an epoch) in
a temporary ``HEAL_SWIN_DATA_ROOT``.  Measured, in this one process:

- ``loader``: the train loader alone (host decode and collate on its 2 threads), img/s;
- ``bare``: ``train_step`` on one projected batch already on the card, img/s;
- ``bare+loader``: the same while a thread iterates the train loader without pause, so
  the host's decode competes with the step's launches;
- ``Trainer.fit`` of ``EPOCHS`` epochs without validation, in turns (the list, then
  reversed, ``ROUNDS`` times): ``real`` (the datamodule as configured, a checkpoint saved each epoch),
  ``no_ckpt`` (no checkpoints) and ``cached`` (every sample decoded once into memory
  before the fit, no checkpoints).  For each: the last epoch's rate from its
  ``train_time_per_sample``, and its steady rate after its first step (CUDA events).

The last line is a JSON object of the results.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

N_PER_CAM = 4
EPOCHS = 4
LOADER_EPOCHS = 2
BARE_STEPS = 8
VARIANTS = ("real", "no_ckpt", "cached")
ROUNDS = 2


class _Run:
    """A tracking run that keeps the logged metrics in memory."""

    run_id = None

    def __init__(self):
        self.metrics = {}

    def log_metrics(self, metrics, step=0):
        for k, v in metrics.items():
            self.metrics.setdefault(k, []).append(v)


class _Cached:
    """A dataset's samples, decoded once."""

    def __init__(self, ds):
        self.items = [ds[i] for i in range(len(ds))]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def loader_rate(dm):
    loader = dm.train_dataloader()
    n, t = 0, time.perf_counter()
    for epoch in range(LOADER_EPOCHS):
        loader.set_epoch(epoch)
        for imgs, _ in loader:
            n += imgs.shape[0]
    return n / (time.perf_counter() - t)


def bare_rate(task, batch, with_loader=None):
    """``train_step`` img/s on ``batch``; with ``with_loader``, while a thread iterates
    that datamodule's train loader."""
    from heal_swin_torch.training.optimizer import make_optimizer

    opt = make_optimizer(task.model.parameters(), task.optimizer_config)
    imgs, targets = batch
    _, _, _, mstate = cs.train_rate(task, opt, task.metric_init(), imgs, targets, 0, 2)
    stop, decoded = threading.Event(), [0]

    def churn():
        loader = with_loader.train_dataloader()
        epoch = 0
        while not stop.is_set():
            loader.set_epoch(epoch)
            epoch += 1
            for imgs_h, _ in loader:
                decoded[0] += imgs_h.shape[0]
                if stop.is_set():
                    break

    thread = None
    if with_loader is not None:
        thread = threading.Thread(target=churn, daemon=True)
        thread.start()
        time.sleep(0.5)
    try:
        rate, _, _, _ = cs.train_rate(task, opt, mstate, imgs, targets, 2, BARE_STEPS)
    finally:
        stop.set()
        if thread is not None:
            thread.join(timeout=60)
    return rate, decoded[0]


def fit_rates(task, dm, pl, tc, dev, variant, root):
    from heal_swin_torch.training.trainer import Trainer

    run = _Run()
    ckpt = root / f"ckpt_{variant}_{time.perf_counter_ns()}" if variant == "real" else None
    trainer = Trainer(pl, tc, run=run, ckpt_dir=ckpt, device=dev)
    t = time.perf_counter()
    trainer.fit(task, dm)
    seconds = time.perf_counter() - t
    if ckpt is not None:
        shutil.rmtree(ckpt, ignore_errors=True)
    return dict(epoch_img_s=1e3 / run.metrics["train_time_per_sample in ms"][-1],
                steady_img_s=trainer.last_train_steady_samples / trainer.last_train_steady_time,
                per_sample_ms=run.metrics["train_time_per_sample in ms"], seconds=seconds)


def main():
    if not torch.cuda.is_available():
        print("real_path_timing: no CUDA device", file=sys.stderr)
        return 1
    import dataclasses

    from heal_swin_torch import _build
    from heal_swin_torch.data.data import get_data_module
    from heal_swin_torch.data.synthetic_woodscape import generate
    from heal_swin_torch.train import build_task
    from heal_swin_torch.training.train_config import PLConfig
    from heal_swin_torch.utils.utils import get_config_from_config_path

    cs.log(cs.nvidia_smi())
    _build.lib()
    dev = torch.device("cuda", 0)
    root = Path(tempfile.mkdtemp(prefix="real_path_timing_"))
    os.environ["HEAL_SWIN_DATA_ROOT"] = str(root)
    try:
        generate(root, version="woodscape", n_per_cam=N_PER_CAM, W=1280, H=966, seed=0)
        cfg = str(Path(cs.__file__).resolve().parent / cs.CONFIGS
                  / "smoke_convergence_run_config.py")
        rc = get_config_from_config_path(cfg, "get_train_run_config")
        dm, spec = get_data_module(rc.data)
        task = build_task(rc.model, spec, rc.data, device=dev)
        (_, _), (imgs, targets) = cs.first_val_batch(dm, dev)
        with torch.no_grad():
            batch = dm.device_batch_transform(imgs, targets)
        out = {"loader_img_s": loader_rate(dm)}
        bare, beside = [], []
        for _ in range(ROUNDS):  # in turns: bare, beside a loader, beside, bare
            bare.append(bare_rate(task, batch)[0])
            beside.append(bare_rate(task, batch, dm))
            beside.append(bare_rate(task, batch, dm))
            bare.append(bare_rate(task, batch)[0])
        out["bare_img_s"] = statistics.median(bare)
        out["bare_with_loader_img_s"] = statistics.median(r for r, _ in beside)
        cs.log(f"loader alone {out['loader_img_s']:.4f} img/s; bare train_step "
               + " ".join(f"{r:.4f}" for r in bare) + " img/s, while the loader decodes "
               + " ".join(f"{r:.4f} ({n} images)" for r, n in beside))
        pl = PLConfig(max_epochs=EPOCHS, check_val_every_n_epoch=10 ** 6,
                      num_sanity_val_steps=0, log_every_n_steps=10 ** 6)
        tc = dataclasses.replace(rc.train, eval_after_train=False)
        real_train = dm.train_dataset
        cached_train = _Cached(real_train)
        fits = {v: [] for v in VARIANTS}
        for variant in (VARIANTS + VARIANTS[::-1]) * ROUNDS:
            dm.train_dataset = cached_train if variant == "cached" else real_train
            r = fit_rates(task, dm, pl, tc, dev, variant, root)
            fits[variant].append(r)
            cs.log(f"fit {variant}: last epoch {r['epoch_img_s']:.4f} img/s, steady "
                   f"{r['steady_img_s']:.4f} img/s after its first step; "
                   "train_time_per_sample " + " ".join(f"{v:.3f}" for v in r["per_sample_ms"])
                   + f" ms; {r['seconds']:.3f} s")
        dm.train_dataset = real_train
        for v, rs in fits.items():
            out[f"fit_{v}_epoch_img_s"] = statistics.median(r["epoch_img_s"] for r in rs)
            out[f"fit_{v}_steady_img_s"] = statistics.median(r["steady_img_s"] for r in rs)
        print(json.dumps(out))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
