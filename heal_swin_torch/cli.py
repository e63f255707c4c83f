"""The port's launcher: ``python3 -m heal_swin_torch.cli <subcommand>`` (the counterpart
of ``heal_swin_tpu/cli.py`` and reference ``run.py``).

Subcommands: ``train``, ``resume`` and ``evaluate`` (``--config_path``; ``--device``,
default the first CUDA device), and ``start-mlflow-server``.  The JAX launcher's
``bench`` waits for the port's benchmark entry; ``test-repo`` and ``format-code`` drive
the repository, not the port.
"""

from __future__ import annotations

import argparse
import subprocess


def main(argv=None):
    from heal_swin_torch.train import add_device_arg

    parser = argparse.ArgumentParser(description="heal-swin-torch launcher")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in ("train", "resume", "evaluate"):
        p = add_device_arg(sub.add_parser(name))
        p.add_argument("--config_path", required=True)
    p = sub.add_parser("start-mlflow-server")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--backend", choices=["filesystem", "builtin"], default="builtin",
                   help="'filesystem' delegates to an installed mlflow binary; "
                        "'builtin' (default) serves the FileStore with the "
                        "lockfile-guarded stdlib server (tracking/server.py)")
    args = parser.parse_args(argv)

    if args.cmd == "train":
        from heal_swin_torch import train

        train.main(["--config_path", args.config_path]
                   + (["--device", args.device] if args.device else []))
    elif args.cmd == "resume":
        from heal_swin_torch import resume
        from heal_swin_torch.utils import utils

        resume_config = utils.get_config_from_config_path(
            args.config_path, "get_resume_run_config")
        pl_config = utils.get_config_from_config_path(args.config_path, "get_pl_config")
        resume.main(args.config_path, pl_config, resume_config, device=args.device)
    elif args.cmd == "evaluate":
        from heal_swin_torch import evaluate

        evaluate.main(["--config_path", args.config_path]
                      + (["--device", args.device] if args.device else []))
    elif args.cmd == "start-mlflow-server":
        # reference run.py:69-120: the filesystem backend delegates to the mlflow
        # binary; the builtin one runs the lockfile-guarded tracking server, which
        # tracking.get_store() then resolves to (reference mlflow_utils.py:8-19)
        from heal_swin_torch.utils.utils import get_mlruns_path

        if args.backend == "filesystem":
            try:
                subprocess.call(["mlflow", "ui", "--backend-store-uri",
                                 f"file://{get_mlruns_path()}", "--port", str(args.port)])
            except FileNotFoundError:
                print("mlflow is not installed; use the default --backend builtin, or "
                      f"browse the FileStore under {get_mlruns_path()} with any mlflow ui "
                      "pointed at it.")
            return
        from heal_swin_torch.tracking.server import serve

        serve(port=args.port)


if __name__ == "__main__":
    main()
