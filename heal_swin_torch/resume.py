"""Resume entry point (the port's counterpart of ``heal_swin_tpu/resume.py``, mirroring
reference ``heal_swin/resume.py``).

Resolves the checkpoint from the run id, sets ``pl_config.resume_from_checkpoint``,
copies the resume config into the original run's artifacts, and delegates to
``train_model`` (a new run; step continuity via ``logging_step_offset``)."""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

from heal_swin_torch.train import add_device_arg, train_model
from heal_swin_torch.training.train_config import ResumeConfig
from heal_swin_torch.utils import utils


def main(config_path, pl_config, resume_config: ResumeConfig, device=None):
    ckpt_path, artifact_path, _ = utils.check_and_get_ckpt_paths(
        resume_config.path, resume_config.epoch, resume_config.epoch_number
    )
    pl_config.resume_from_checkpoint = str(ckpt_path)

    if config_path is not None and Path(config_path).exists():
        shutil.copy(config_path, Path(artifact_path) / Path(config_path).name)

    return train_model(
        run_config=resume_config.train_run_config,
        pl_config=pl_config,
        config_path=config_path,
        device=device,
    )


if __name__ == "__main__":
    parser = add_device_arg(argparse.ArgumentParser())
    parser.add_argument("--config_path", required=True)
    args = parser.parse_args()
    resume_config = utils.get_config_from_config_path(args.config_path, "get_resume_run_config")
    pl_config = utils.get_config_from_config_path(args.config_path, "get_pl_config")
    main(args.config_path, pl_config, resume_config, device=args.device)
