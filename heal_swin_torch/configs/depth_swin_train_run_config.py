#!/usr/bin/env -S python3 -u
"""The paper's flat SWIN-UNet depth run (the port's copy of
``run_configs/depth_estimation/depth_swin_train_run_config.py``; reference
run_configs/depth_estimation/depth_swin_train_run_config.py): the flat paper architecture
in float32 on SynWoodScape depths at 640 x 768, standardized, background masked, the l2
loss, Adam at 0.005 without weight decay, no gradient clipping.  Its PL config asks for 4
GPUs (DDP), which the port's single-process entry refuses: a wrapper config sets ``gpus``.

    python3 -m heal_swin_torch.cli train --config_path <a wrapper of this file>
"""


def get_train_run_config():
    from heal_swin_torch.run_configs import depth_swin_train_run

    return depth_swin_train_run()


def get_pl_config():
    from heal_swin_torch.run_configs import paper_pl_config

    pl = paper_pl_config()
    pl.gradient_clip_val = 0
    return pl


def main():
    import subprocess
    import sys

    subprocess.run([sys.executable, "-u", "-m", "heal_swin_torch.cli", "train",
                    "--config_path", __file__], check=True)


if __name__ == "__main__":
    main()
