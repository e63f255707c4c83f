"""Experiment tracking in the MLflow FileStore on-disk format (the port's copy of
``heal_swin_tpu/tracking/mlflow_store.py``, standard library only).

The reference treats MLflow as its system of record without needing the mlflow
package here: this module writes the directory layout of ``mlflow`` 1.x's file
backend, so ``mlflow ui --backend-store-uri file://<root>`` can browse runs produced
here, the JAX package's store reads them and the other way round, and the resume
tooling resolves run ids -> artifact dirs as the reference's
``utils.check_and_get_ckpt_paths`` does (reference heal_swin/utils/utils.py:141-198).

Layout:
    <root>/<experiment_id>/meta.yaml
    <root>/<experiment_id>/<run_id>/meta.yaml
    <root>/<experiment_id>/<run_id>/metrics/<name>     lines: "<ts_ms> <value> <step>"
    <root>/<experiment_id>/<run_id>/params/<name>      single value
    <root>/<experiment_id>/<run_id>/tags/<name>        single value
    <root>/<experiment_id>/<run_id>/artifacts/...
"""

from __future__ import annotations

import os
import time
import uuid
from pathlib import Path
from typing import Dict, Optional

_INVALID = set('%"\'\n\r:/\\')


def _sanitize(name: str) -> str:
    return "".join("_" if c in _INVALID else c for c in name)


def _yaml_str(s: str) -> str:
    """Single-quote a string for YAML when it would otherwise not parse back
    (run names / tags containing ':', '#', leading symbols, ...)."""
    if s and not any(c in s for c in ":#{}[]&*!|>'\"%@`,") and s == s.strip():
        return s
    return "'" + s.replace("'", "''") + "'"


def _write_meta(path: Path, d: Dict):
    lines = []
    for k, v in d.items():
        if v is None:
            lines.append(f"{k}: null")
        elif isinstance(v, bool):
            lines.append(f"{k}: {'true' if v else 'false'}")
        elif isinstance(v, (int, float)):
            lines.append(f"{k}: {v}")
        else:
            lines.append(f"{k}: {_yaml_str(str(v))}")
    path.write_text("\n".join(lines) + "\n")


def _now_ms() -> int:
    return int(time.time() * 1000)


class MlflowRun:
    def __init__(self, store: "MlflowFileStore", experiment_id: str, run_id: str):
        self.store = store
        self.experiment_id = experiment_id
        self.run_id = run_id
        self.run_dir = store.root / experiment_id / run_id
        self.artifact_dir = self.run_dir / "artifacts"
        for sub in ["metrics", "params", "tags", "artifacts"]:
            (self.run_dir / sub).mkdir(parents=True, exist_ok=True)

    # -- logging ------------------------------------------------------------
    def log_metric(self, name: str, value: float, step: int = 0, timestamp: Optional[int] = None):
        ts = timestamp if timestamp is not None else _now_ms()
        with open(self.run_dir / "metrics" / _sanitize(name), "a") as f:
            f.write(f"{ts} {float(value)} {int(step)}\n")

    def log_metrics(self, metrics: Dict[str, float], step: int = 0):
        for k, v in metrics.items():
            self.log_metric(k, v, step)

    def log_param(self, name: str, value):
        p = self.run_dir / "params" / _sanitize(name)
        if not p.exists():
            p.write_text(str(value))

    def log_params(self, params: Dict):
        for k, v in params.items():
            self.log_param(k, v)

    def set_tag(self, name: str, value):
        (self.run_dir / "tags" / _sanitize(name)).write_text(str(value))

    def get_metric_history(self, name: str):
        p = self.run_dir / "metrics" / _sanitize(name)
        if not p.exists():
            return []
        out = []
        for line in p.read_text().splitlines():
            ts, v, s = line.split()
            out.append((int(ts), float(v), int(s)))
        return out

    def set_status(self, status: str):
        """status: RUNNING | FINISHED | FAILED | KILLED."""
        meta = self.run_dir / "meta.yaml"
        if not self._start_time and meta.exists():
            # a run re-opened via get_run (or the REST server) must not clobber
            # the recorded start_time when it rewrites the meta
            for line in meta.read_text().splitlines():
                if line.startswith("start_time:"):
                    v = line.split(":", 1)[1].strip()
                    self._start_time = int(v) if v.isdigit() else 0
        end = _now_ms() if status != "RUNNING" else None
        _write_meta(
            meta,
            {
                "artifact_uri": f"file://{self.artifact_dir}",
                "end_time": end,
                "entry_point_name": "",
                "experiment_id": self.experiment_id,
                "lifecycle_stage": "active",
                "name": "",
                "run_id": self.run_id,
                "run_uuid": self.run_id,
                "source_name": "",
                "source_type": 4,
                "source_version": "",
                "start_time": self._start_time,
                "status": {"RUNNING": 1, "FINISHED": 3, "FAILED": 4, "KILLED": 5}.get(status, 1),
                "tags": [],
                "user_id": os.environ.get("USER", "unknown"),
            },
        )
        self.set_tag("mlflow.runStatus", status)

    @property
    def status(self) -> str:
        tag = self.run_dir / "tags" / "mlflow.runStatus"
        return tag.read_text() if tag.exists() else "RUNNING"

    _start_time: int = 0


class MlflowFileStore:
    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _experiment_ids(self):
        return [
            p.name
            for p in self.root.iterdir()
            if p.is_dir() and (p / "meta.yaml").exists() and p.name != ".trash"
        ]

    def get_or_create_experiment(self, name: str) -> str:
        # compare against the YAML-QUOTED form too: names containing ':' / '#' /
        # ',' etc. are stored single-quoted by _yaml_str, and a raw-only compare
        # would re-create the experiment on every run
        wanted = {name, _yaml_str(name)}
        for eid in self._experiment_ids():
            meta = (self.root / eid / "meta.yaml").read_text()
            for line in meta.splitlines():
                if line.startswith("name:") and line.split(":", 1)[1].strip() in wanted:
                    return eid
        ids = [int(e) for e in self._experiment_ids() if e.isdigit()]
        eid = str(max(ids) + 1 if ids else 0)
        d = self.root / eid
        d.mkdir(parents=True, exist_ok=True)
        _write_meta(
            d / "meta.yaml",
            {
                "artifact_location": f"file://{d}",
                "experiment_id": eid,
                "lifecycle_stage": "active",
                "name": name,
            },
        )
        return eid

    def create_run(self, experiment_name: str, run_name: Optional[str] = None) -> MlflowRun:
        eid = self.get_or_create_experiment(experiment_name)
        run_id = uuid.uuid4().hex
        run = MlflowRun(self, eid, run_id)
        run._start_time = _now_ms()
        run.set_status("RUNNING")
        if run_name:
            run.set_tag("mlflow.runName", run_name)
        return run

    def get_run(self, run_id: str) -> MlflowRun:
        for eid in self._experiment_ids():
            d = self.root / eid / run_id
            if d.is_dir():
                run = MlflowRun(self, eid, run_id)
                return run
        raise KeyError(f"run id {run_id} not found under {self.root}")

    def find_artifacts_dir(self, run_id: str) -> Path:
        return self.get_run(run_id).artifact_dir
