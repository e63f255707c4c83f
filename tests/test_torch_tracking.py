"""The port's tracking (``heal_swin_torch/tracking``) against the JAX package's: a run
written by either package's FileStore is read back by the other's (params, tags,
metric histories, status, start time, artifacts dir); experiment names that need YAML
quoting are found again; the lock-file server and its HTTP endpoints, and the REST
write path through ``tracking.get_store``, as ``tests/test_aux.py`` exercises the JAX
package's; the config snapshots of ``utils/serialize.py`` (pickle) and
``utils.load_config``."""

import dataclasses
import json
import threading
import urllib.request

import pytest

from heal_swin_torch import tracking as ttracking
from heal_swin_torch.data.data_config import WoodscapeCommonConfig, WoodscapeHPConfig
from heal_swin_torch.tracking import client as tclient
from heal_swin_torch.tracking import mlflow_store as tstore
from heal_swin_torch.tracking import server as tserver
from heal_swin_torch.utils import serialize, utils
from heal_swin_tpu.tracking import mlflow_store as jstore
from heal_swin_tpu.tracking import server as jserver
from heal_swin_tpu.utils import serialize as jserialize

STORES = {"port": tstore.MlflowFileStore, "jax": jstore.MlflowFileStore}


def _write_run(store):
    run = store.create_run("cross: expt", run_name="run #1")
    run.log_param("lr", 0.1)
    run.log_params({"bs": 2, "model.embed_dim": 96})
    run.log_metric("val_loss", 1.5, step=0)
    run.log_metrics({"val_loss": 1.25, "device0 memory.used in MB": 3.5}, step=1)
    run.set_tag("cmd", "train")
    (run.artifact_dir / "checkpoints").mkdir()
    run.set_status("FINISHED")
    return run


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_filestore_runs_cross_read(tmp_path, writer, reader):
    run = _write_run(STORES[writer](tmp_path))
    store = STORES[reader](tmp_path)
    got = store.get_run(run.run_id)
    assert got.status == "FINISHED" and got.experiment_id == run.experiment_id
    assert [(v, s) for _, v, s in got.get_metric_history("val_loss")] == [(1.5, 0), (1.25, 1)]
    assert got.get_metric_history("device0 memory.used in MB")[0][1:] == (3.5, 1)
    assert (got.run_dir / "params" / "bs").read_text() == "2"
    assert (got.run_dir / "tags" / "mlflow.runName").read_text() == "run #1"
    assert store.find_artifacts_dir(run.run_id) == run.artifact_dir
    assert (store.find_artifacts_dir(run.run_id) / "checkpoints").is_dir()
    assert store.get_or_create_experiment("cross: expt") == run.experiment_id
    meta = (got.run_dir / "meta.yaml").read_text()
    start = next(ln for ln in meta.splitlines() if ln.startswith("start_time:"))
    assert int(start.split(":")[1]) > 0
    # the reader's server shows the writer's run
    srv = tserver if reader == "port" else jserver
    runs = dict(srv._runs(tmp_path, run.experiment_id))
    assert runs[run.run_id]["status_str"] == "FINISHED"
    assert runs[run.run_id]["run_name"] == "run #1"


@pytest.mark.parametrize("name", ["seg: paper", "a#b", "plain", "x, y"])
def test_experiment_name_needing_yaml_quoting_is_reused(tmp_path, name):
    store = tstore.MlflowFileStore(tmp_path / "mlruns")
    e1 = store.get_or_create_experiment(name)
    assert store.get_or_create_experiment(name) == e1
    assert jstore.MlflowFileStore(tmp_path / "mlruns").get_or_create_experiment(name) == e1


def test_tracking_server_lockfile_and_http(tmp_path):
    mlruns = tmp_path / "mlruns"
    store = tstore.MlflowFileStore(mlruns)
    run = store.create_run("server_expt", run_name="myrun")
    run.log_param("lr", 0.1)
    run.log_metric("val_loss", 1.5, step=0)
    run.log_metric("val_loss", 1.25, step=1)
    run.set_status("FINISHED")
    assert tserver.get_tracking_uri(mlruns) == f"file://{mlruns}"

    server = tserver.TrackingServer(mlruns, port=0, host="127.0.0.1").start()
    try:
        lock = tserver.tracking_server_file_path(mlruns)
        data = json.loads(lock.read_text())
        assert {"user", "start_time", "host", "port", "workers", "timeout"} <= set(data)
        uri = f"http://{data['host']}:{data['port']}"
        assert tserver.get_tracking_uri(mlruns) == uri == jserver.get_tracking_uri(mlruns)
        with pytest.raises(RuntimeError, match="already running"):
            tserver.TrackingServer(mlruns, port=0).start()
        threading.Thread(target=server.httpd.serve_forever, daemon=True).start()

        def get_json(path):
            with urllib.request.urlopen(uri + path, timeout=10) as r:
                return json.loads(r.read())

        exps = get_json("/?format=json")["experiments"]
        eid = next(e["experiment_id"] for e in exps if e.get("name") == "server_expt")
        runs = get_json(f"/experiments/{eid}?format=json")["runs"]
        assert runs[0]["run_id"] == run.run_id and runs[0]["run_name"] == "myrun"
        payload = get_json(f"/experiments/{eid}/runs/{run.run_id}?format=json")
        assert payload["params"]["lr"] == "0.1" and payload["metrics"]["val_loss"] == 1.25
        hist = get_json(f"/experiments/{eid}/runs/{run.run_id}/metrics/val_loss")
        assert [h["value"] for h in hist["history"]] == [1.5, 1.25]
    finally:
        server.stop()
    assert not tserver.tracking_server_file_path(mlruns).is_file()
    assert tserver.get_tracking_uri(mlruns) == f"file://{mlruns}"


def test_tracking_server_rest_write_path(tmp_path):
    """While the server runs, ``get_store`` resolves to the REST client, whose writes
    land in the server's FileStore (read back by both packages' stores); once it
    stops, to the FileStore."""
    mlruns = tmp_path / "mlruns"
    server = tserver.TrackingServer(mlruns, port=0, host="127.0.0.1").start()
    try:
        threading.Thread(target=server.httpd.serve_forever, daemon=True).start()
        store = ttracking.get_store(mlruns)
        assert isinstance(store, tclient.MlflowRestStore)
        run = store.create_run("rest_expt", run_name="restrun")
        run.log_param("lr", 0.01)
        run.log_params({"bs": 2})
        run.log_metric("train_loss", 2.0, step=0)
        run.log_metrics({"train_loss": 1.0, "acc": 0.5}, step=1)
        run.set_tag("cmd", "unit-test")
        run.set_status("FINISHED")
        assert run.artifact_dir.is_dir()
        for fs in (tstore.MlflowFileStore(mlruns), jstore.MlflowFileStore(mlruns)):
            fs_run = fs.get_run(run.run_id)
            assert fs_run.run_dir == run.run_dir and fs_run.status == "FINISHED"
            assert (fs_run.run_dir / "params" / "lr").read_text() == "0.01"
            assert [v for _, v, _ in fs_run.get_metric_history("train_loss")] == [2.0, 1.0]
        assert [v for _, v, _ in run.get_metric_history("acc")] == [0.5]
        assert store.get_run(run.run_id).artifact_dir == run.artifact_dir
    finally:
        server.stop()
    assert isinstance(ttracking.get_store(mlruns), tstore.MlflowFileStore)


def test_config_snapshots(tmp_path, monkeypatch):
    """serialize.save / load round trip a config (pickle), ``flatten_config`` gives the
    JAX package's keys, and ``load_config`` finds a run's snapshot."""
    cfg = WoodscapeHPConfig(common=WoodscapeCommonConfig(version="synthetic", batch_size=3))
    monkeypatch.setenv("HEAL_SWIN_MLRUNS", str(tmp_path / "mlruns"))
    run = tstore.MlflowFileStore(utils.get_mlruns_path()).create_run("cfg")
    serialize.save(cfg, run.artifact_dir / "data_config")
    assert serialize.load(run.artifact_dir / "data_config") == cfg
    assert utils.load_config(run.run_id, "data_config") == cfg
    flat = serialize.flatten_config(cfg, "data.")
    assert flat == jserialize.flatten_config(cfg, "data.")
    assert flat["data.common.batch_size"] == 3 and flat["data.input_nside"] == 256
    assert dataclasses.asdict(cfg) == serialize.to_plain(cfg)
