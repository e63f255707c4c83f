"""REST tracking client: logs through a running built-in tracking server (the port's
copy of ``heal_swin_tpu/tracking/client.py``).

The reference's training logger talks to ``mlflow server`` over HTTP when the
server lockfile exists (reference ``utils/mlflow_utils.py:8-19`` resolves the
tracking URI, the MlflowLogger then posts runs/metrics/params to it).  This is
the equivalent client for ``tracking/server.py``'s ``/api`` endpoints: it
exposes the same store/run surface as ``tracking/mlflow_store.py``
(``create_run`` / ``get_run`` returning runs with ``log_metric(s)`` /
``log_param(s)`` / ``set_tag`` / ``set_status`` / ``artifact_dir``), so the
trainer and evaluators can use either interchangeably —
``tracking.get_store()`` picks this one whenever ``get_tracking_uri()``
resolves to ``http://``.

Artifacts (checkpoints, plots, serialized configs) are still written directly
to ``artifact_dir`` — the server returns that path at run creation and the
reference makes the same shared-filesystem assumption (its mlflow artifact URIs
are ``file://`` paths on the cluster filesystem).
"""

from __future__ import annotations

import json
import urllib.request
from pathlib import Path
from typing import Dict, Optional


class MlflowRestRun:
    def __init__(self, store: "MlflowRestStore", experiment_id: str, run_id: str,
                 artifact_dir: str):
        self.store = store
        self.experiment_id = experiment_id
        self.run_id = run_id
        self.artifact_dir = Path(artifact_dir)
        self.run_dir = self.artifact_dir.parent

    def _op(self, op: str, **kw):
        self.store._post("/api/run-op", dict(kw, op=op, run_id=self.run_id,
                                             experiment_id=self.experiment_id))

    def log_metric(self, name: str, value: float, step: int = 0,
                   timestamp: Optional[int] = None):
        self._op("log_metric", name=name, value=float(value), step=int(step),
                 timestamp=timestamp)

    def log_metrics(self, metrics: Dict[str, float], step: int = 0):
        self._op("log_metrics", metrics={k: float(v) for k, v in metrics.items()},
                 step=int(step))

    def log_param(self, name: str, value):
        self._op("log_param", name=name, value=str(value))

    def log_params(self, params: Dict):
        self._op("log_params", params={k: str(v) for k, v in params.items()})

    def set_tag(self, name: str, value):
        self._op("set_tag", name=name, value=str(value))

    def set_status(self, status: str):
        self._op("set_status", status=status)

    def get_metric_history(self, name: str):
        url = (f"{self.store.uri}/experiments/{self.experiment_id}"
               f"/runs/{self.run_id}/metrics/{name}")
        with urllib.request.urlopen(url, timeout=self.store.timeout) as r:
            hist = json.loads(r.read())["history"]
        return [(h["timestamp"], h["value"], h["step"]) for h in hist]


class MlflowRestStore:
    """Same surface as MlflowFileStore, writes via the tracking server."""

    def __init__(self, uri: str, timeout: float = 30.0):
        self.uri = uri.rstrip("/")
        self.timeout = timeout

    def _post(self, path: str, payload: dict) -> dict:
        req = urllib.request.Request(
            self.uri + path,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read())
        except urllib.error.URLError as exc:
            raise RuntimeError(
                f"tracking server at {self.uri} unreachable ({exc}); if it is "
                "gone, remove the stale tracking_server_running.json lockfile"
            ) from exc

    def create_run(self, experiment_name: str, run_name: Optional[str] = None
                   ) -> MlflowRestRun:
        r = self._post("/api/create-run",
                       {"experiment_name": experiment_name, "run_name": run_name})
        return MlflowRestRun(self, r["experiment_id"], r["run_id"], r["artifact_dir"])

    def get_run(self, run_id: str) -> MlflowRestRun:
        r = self._post("/api/get-run", {"run_id": run_id})
        return MlflowRestRun(self, r["experiment_id"], r["run_id"], r["artifact_dir"])

    def find_artifacts_dir(self, run_id: str) -> Path:
        return self.get_run(run_id).artifact_dir
