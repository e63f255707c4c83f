"""Built-in tracking server: the reference's MLflow-server workflow without mlflow
(the port's copy of ``heal_swin_tpu/tracking/server.py``, standard library only).

The reference launches ``mlflow server`` (sqlite- or file-backed) guarded by a
``tracking_server_running.json`` lockfile and resolves the tracking URI from that
file (reference ``run.py:69-120`` ``mlf_server`` + ``utils/mlflow_utils.py:8-19``
``get_tracking_uri``).  This module reproduces the protocol
without the mlflow package:

- ``serve(mlruns, port)``: a stdlib HTTP server over the FileStore written by
  ``tracking/mlflow_store.py`` — GET endpoints browse experiments -> runs ->
  params/metrics (HTML plus ``?format=json``), POST endpoints under ``/api/``
  accept remote client logging (create-run / run-op), mirroring the write REST
  surface the reference relies on when training routes through ``mlflow
  server``.  It writes the reference's lockfile (user/start_time/host/port),
  refuses to double-start, and removes the lockfile on shutdown —
  byte-compatible fields with the reference's ``server_data`` dict.
- ``get_tracking_uri()``: lockfile present -> ``http://<host>:<port>`` (the
  reference's sqlite-backend resolution); otherwise ``file://<mlruns>`` (the
  filesystem backend).  Consumed by ``tracking.get_store()``: the train and
  evaluate entry points resolve their store through it, so a running server
  captures their logging exactly like the reference's
  ``utils/mlflow_utils.py:8-19`` routing.
"""

from __future__ import annotations

import datetime
import getpass
import html
import json
import socket
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse


def tracking_server_file_path(mlruns=None) -> Path:
    """Lockfile location (reference get_paths.get_tracking_server_file_path):
    next to — not inside — the FileStore root, so the store stays pure."""
    from heal_swin_torch.utils.utils import get_mlruns_path

    root = Path(mlruns) if mlruns is not None else get_mlruns_path()
    return root.parent / "tracking_server_running.json"


def get_tracking_uri(mlruns=None) -> str:
    """Reference utils/mlflow_utils.py:8-19: a running tracking server (lockfile)
    wins; otherwise the FileStore file:// URI."""
    from heal_swin_torch.utils.utils import get_mlruns_path

    root = Path(mlruns) if mlruns is not None else get_mlruns_path()
    lock = tracking_server_file_path(root)
    if lock.is_file():
        data = json.loads(lock.read_text())
        return f"http://{data['host']}:{data['port']}"
    return f"file://{root}"


# --------------------------------------------------------------------- store read
def _read_meta(path: Path) -> dict:
    out = {}
    if not path.is_file():
        return out
    for line in path.read_text().splitlines():
        if ":" in line:
            k, v = line.split(":", 1)
            v = v.strip()
            if v.startswith("'") and v.endswith("'"):
                v = v[1:-1].replace("''", "'")
            out[k.strip()] = v
    return out


def _experiments(root: Path):
    for p in sorted(root.iterdir()) if root.is_dir() else []:
        if p.is_dir() and (p / "meta.yaml").exists() and p.name != ".trash":
            yield p.name, _read_meta(p / "meta.yaml")


def _runs(root: Path, eid: str):
    d = root / eid
    for p in sorted(d.iterdir()) if d.is_dir() else []:
        if p.is_dir() and (p / "meta.yaml").exists():
            meta = _read_meta(p / "meta.yaml")
            tag = p / "tags" / "mlflow.runName"
            meta["run_name"] = tag.read_text() if tag.exists() else ""
            st = p / "tags" / "mlflow.runStatus"
            meta["status_str"] = st.read_text() if st.exists() else "RUNNING"
            yield p.name, meta


def _kv_dir(d: Path) -> dict:
    return (
        {p.name: p.read_text() for p in sorted(d.iterdir()) if p.is_file()}
        if d.is_dir()
        else {}
    )


def _metric_history(run_dir: Path, name: str):
    p = run_dir / "metrics" / name
    if not p.is_file():
        return []
    out = []
    for line in p.read_text().splitlines():
        ts, v, s = line.split()
        out.append({"timestamp": int(ts), "value": float(v), "step": int(s)})
    return out


def _run_payload(run_dir: Path) -> dict:
    metrics = {}
    mdir = run_dir / "metrics"
    if mdir.is_dir():
        for p in sorted(mdir.iterdir()):
            hist = _metric_history(run_dir, p.name)
            if hist:
                metrics[p.name] = hist[-1]["value"]
    return {
        "params": _kv_dir(run_dir / "params"),
        "tags": _kv_dir(run_dir / "tags"),
        "metrics": metrics,
    }


# ------------------------------------------------------------------------- http
def _make_handler(root: Path):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, body: str, ctype="text/html; charset=utf-8", code=200):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _json(self, obj):
            self._send(json.dumps(obj, indent=1), "application/json")

        def do_GET(self):  # noqa: N802 (http.server API)
            url = urlparse(self.path)
            as_json = parse_qs(url.query).get("format", [""])[0] == "json"
            parts = [p for p in url.path.split("/") if p]
            e = html.escape
            try:
                if not parts:  # index: experiments
                    exps = list(_experiments(root))
                    if as_json:
                        return self._json(
                            {"experiments": [dict(m, experiment_id=eid) for eid, m in exps]}
                        )
                    rows = "".join(
                        f'<li><a href="/experiments/{eid}">{eid}: '
                        f'{e(m.get("name", ""))}</a></li>'
                        for eid, m in exps
                    )
                    return self._send(
                        f"<h1>heal-swin tracking ({e(str(root))})</h1><ul>{rows}</ul>"
                    )
                if parts[0] == "experiments" and len(parts) == 2:
                    runs = list(_runs(root, parts[1]))
                    if as_json:
                        return self._json(
                            {"runs": [dict(m, run_id=rid) for rid, m in runs]}
                        )
                    rows = "".join(
                        f'<tr><td><a href="/experiments/{parts[1]}/runs/{rid}">{rid}'
                        f"</a></td><td>{e(m['run_name'])}</td>"
                        f"<td>{e(m['status_str'])}</td></tr>"
                        for rid, m in runs
                    )
                    return self._send(
                        f"<h1>experiment {parts[1]}</h1><table border=1>"
                        f"<tr><th>run</th><th>name</th><th>status</th></tr>{rows}</table>"
                    )
                if parts[0] == "experiments" and len(parts) >= 4 and parts[2] == "runs":
                    run_dir = root / parts[1] / parts[3]
                    if not run_dir.is_dir():
                        return self._send("run not found", code=404)
                    if len(parts) == 6 and parts[4] == "metrics":
                        return self._json(
                            {"metric": parts[5],
                             "history": _metric_history(run_dir, parts[5])}
                        )
                    payload = _run_payload(run_dir)
                    if as_json:
                        return self._json(payload)
                    sec = []
                    for title, kv in [("params", payload["params"]),
                                      ("tags", payload["tags"])]:
                        rows = "".join(
                            f"<tr><td>{e(k)}</td><td>{e(v)}</td></tr>"
                            for k, v in kv.items()
                        )
                        sec.append(f"<h2>{title}</h2><table border=1>{rows}</table>")
                    rows = "".join(
                        f'<tr><td><a href="/experiments/{parts[1]}/runs/{parts[3]}'
                        f'/metrics/{e(k)}">{e(k)}</a></td><td>{v}</td></tr>'
                        for k, v in payload["metrics"].items()
                    )
                    sec.append(f"<h2>metrics (last value)</h2><table border=1>{rows}</table>")
                    return self._send(f"<h1>run {parts[3]}</h1>" + "".join(sec))
                return self._send("not found", code=404)
            except BrokenPipeError:
                pass

        def do_POST(self):  # noqa: N802 (http.server API)
            """Write API: lets a remote client log through this server into the
            FileStore — the reference's ``mlflow server`` accepts client logging
            over REST the same way (reference run.py:69-120 + the training
            logger routing in utils/mlflow_utils.py:8-19).  Consumed by
            tracking/client.py MlflowRestStore."""
            from heal_swin_torch.tracking.mlflow_store import MlflowFileStore, MlflowRun

            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                store = MlflowFileStore(root)
                url = urlparse(self.path)
                if url.path == "/api/create-run":
                    run = store.create_run(body["experiment_name"], body.get("run_name"))
                    return self._json({"experiment_id": run.experiment_id,
                                       "run_id": run.run_id,
                                       "artifact_dir": str(run.artifact_dir)})
                if url.path == "/api/get-run":
                    run = store.get_run(body["run_id"])
                    return self._json({"experiment_id": run.experiment_id,
                                       "run_id": run.run_id,
                                       "artifact_dir": str(run.artifact_dir)})
                if url.path == "/api/run-op":
                    run = MlflowRun(store, body["experiment_id"], body["run_id"])
                    op = body["op"]
                    if op == "log_metric":
                        run.log_metric(body["name"], body["value"],
                                       body.get("step", 0), body.get("timestamp"))
                    elif op == "log_metrics":
                        run.log_metrics(body["metrics"], body.get("step", 0))
                    elif op == "log_param":
                        run.log_param(body["name"], body["value"])
                    elif op == "log_params":
                        run.log_params(body["params"])
                    elif op == "set_tag":
                        run.set_tag(body["name"], body["value"])
                    elif op == "set_status":
                        run.set_status(body["status"])
                    else:
                        return self._send(f"unknown op {op}", code=400)
                    return self._json({"ok": True})
                return self._send("not found", code=404)
            except BrokenPipeError:
                pass
            except KeyError as exc:
                self._send(f"bad request: {exc}", code=400)
            except Exception as exc:  # surface store errors to the client
                self._send(f"error: {exc}", code=500)

    return Handler


class TrackingServer:
    """Lockfile-guarded FileStore HTTP server (reference run.py mlf_server)."""

    def __init__(self, mlruns=None, port: int = 5000, host: str = "127.0.0.1"):
        from heal_swin_torch.utils.utils import get_mlruns_path

        self.root = Path(mlruns) if mlruns is not None else get_mlruns_path()
        self.port = port
        self.host = host
        self.lock = tracking_server_file_path(self.root)
        self.httpd = None

    def start(self):
        if self.lock.is_file():
            data = json.loads(self.lock.read_text())
            raise RuntimeError(
                f"The tracking server is already running on the host {data['host']},"
                f" listening to port {data['port']}. It was started at"
                f" {data['start_time']} by the user {data['user']}. Aborting."
            )
        self.httpd = ThreadingHTTPServer((self.host, self.port), _make_handler(self.root))
        self.port = self.httpd.server_address[1]  # resolve port 0
        self.lock.parent.mkdir(parents=True, exist_ok=True)
        self.lock.write_text(json.dumps({
            "user": getpass.getuser(),
            "start_time": datetime.datetime.now().strftime("%H:%M:%S %d-%m-%Y"),
            "host": self.host if self.host != "0.0.0.0" else socket.gethostname(),
            "port": self.port,
            "workers": 1,
            "timeout": 600,
        }))
        return self

    def serve_forever(self):
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def stop(self):
        # The lockfile unlink must survive a KeyboardInterrupt landing mid-stop
        # (e.g. a second SIGTERM during Ctrl-C cleanup) — a stale lockfile blocks
        # every future start, which is the condition this shutdown path exists to
        # prevent.  Hence the finally, and stop() is idempotent.
        try:
            if self.httpd is not None:
                self.httpd.shutdown()
                self.httpd.server_close()
                self.httpd = None
        finally:
            if self.lock.is_file():
                self.lock.unlink()
                print(f"removed server file {self.lock}")


def serve(mlruns=None, port: int = 5000, host: str = "0.0.0.0"):
    """Blocking entry point for the CLI (start-mlflow-server)."""
    import signal

    # a stale lockfile makes every later start abort and get_tracking_uri point
    # at a dead server, so clean up on SIGTERM too (kill, not just ctrl-C); the
    # raise unwinds serve_forever in the main thread, whose finally runs stop().
    # The handler first disarms itself so a SECOND SIGTERM cannot re-raise inside
    # stop() and skip the unlink, and it is installed BEFORE start() so the
    # window covers the moment the lockfile is written.
    def _term(*_):
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    server = TrackingServer(mlruns, port, host).start()
    print(f"tracking server listening on http://{server.host}:{server.port} "
          f"over {server.root} (lockfile {server.lock})")
    server.serve_forever()
