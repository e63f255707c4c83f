#!/usr/bin/env -S python3 -u
"""The paper's flat SWIN-UNet segmentation run (the port's copy of
``run_configs/segmentation/swin_synwoodscape_large_train_run_config.py``; reference
run_configs/segmentation/swin_synwoodscape_large_train_run_config.py): the flat paper
architecture in float32 on SynWoodScape-large at 640 x 768, batch 2, Adam at the paper
rate, the class-balancing weights.  Its PL config asks for 4 GPUs (DDP), which the port's
single-process entry refuses: a wrapper config sets ``gpus``.

    python3 -m heal_swin_torch.cli train --config_path <a wrapper of this file>
"""


def get_train_run_config():
    from heal_swin_torch.run_configs import SYNWOODSCAPE_LARGE_WEIGHTS, flat_seg_train_run

    return flat_seg_train_run(version="synwoodscape_large", expmt="synwoodscape_large",
                              class_weights=SYNWOODSCAPE_LARGE_WEIGHTS)


def get_pl_config():
    from heal_swin_torch.run_configs import paper_pl_config

    return paper_pl_config()


def main():
    import subprocess
    import sys

    subprocess.run([sys.executable, "-u", "-m", "heal_swin_torch.cli", "train",
                    "--config_path", __file__], check=True)


if __name__ == "__main__":
    main()
