"""Experiment tracking: MLflow FileStore format + built-in server + REST client (the
port's copy of ``heal_swin_tpu/tracking``, standard library only).

``get_store()`` is the entry-point resolution the reference implements in
``utils/mlflow_utils.py:8-19``: when the tracking-server lockfile exists, the
training/eval loggers talk to the server over HTTP; otherwise they write the
FileStore directly.  Both stores expose the same surface (create_run/get_run,
runs with log_metric(s)/log_param(s)/set_tag/set_status/artifact_dir).
"""

from __future__ import annotations


def get_store(mlruns=None):
    from heal_swin_torch.tracking.server import get_tracking_uri

    uri = get_tracking_uri(mlruns)
    if uri.startswith("http://"):
        from heal_swin_torch.tracking.client import MlflowRestStore

        return MlflowRestStore(uri)
    from heal_swin_torch.tracking.mlflow_store import MlflowFileStore

    return MlflowFileStore(uri.removeprefix("file://"))
