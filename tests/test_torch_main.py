"""The port's entry point, ``python -m kubetpu_torch --device cpu``
(kubetpu_torch/__main__.py): twins of tests/test_main.py (reference:
cmd/kube-scheduler/scheduler.go:1, app/server.go:69-218 — config load,
serving, leader election with fatal lease loss).  Every subprocess wait
is bounded."""
import json
import os
import subprocess
import sys
import time

import pytest
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_once_mode_schedules_hollow_cluster():
    proc = subprocess.run(
        [sys.executable, "-m", "kubetpu_torch", "--device", "cpu", "--once",
         "--hollow-nodes", "8", "--hollow-pods", "12"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(l) for l in proc.stdout.splitlines() if l.strip()]
    summary = lines[-1]
    assert summary["scheduled"] == 12
    assert lines[0]["kubetpu"] == "started"


def test_bad_config_exits_2(tmp_path):
    cfg = tmp_path / "bad.yaml"
    cfg.write_text("kind: NotASchedulerConfig\n")
    proc = subprocess.run(
        [sys.executable, "-m", "kubetpu_torch", "--device", "cpu",
         "--config", str(cfg), "--once"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "error loading --config" in proc.stderr


def test_config_file_drives_mode(tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(
        "apiVersion: kubescheduler.config.k8s.io/v1alpha2\n"
        "kind: KubeSchedulerConfiguration\n"
        "mode: gang\n"
        "batchSize: 64\n"
        "profiles:\n"
        "- schedulerName: default-scheduler\n")
    proc = subprocess.run(
        [sys.executable, "-m", "kubetpu_torch", "--device", "cpu",
         "--config", str(cfg), "--once",
         "--hollow-nodes", "4", "--hollow-pods", "4"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    started = json.loads(proc.stdout.splitlines()[0])
    assert started["mode"] == "gang"


def test_lease_loss_is_fatal(tmp_path):
    """reference: app/server.go:203-218 — the scheduler exits when it loses
    the leader lease, so a standby can take over."""
    lock = tmp_path / "lease.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubetpu_torch", "--device", "cpu",
         "--leader-elect", "--lock-file", str(lock),
         "--lock-identity", "victim",
         "--lease-duration", "1.0", "--retry-period", "0.2",
         "--hollow-nodes", "2"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            if lock.exists():
                rec = json.loads(lock.read_text())
                if rec.get("holder") == "victim":
                    break
            time.sleep(0.1)
        else:
            pytest.fail("scheduler never acquired the lease")
        # steal the lease from outside the process through the production
        # lock (flock + atomic replace) so the victim's reader can never
        # observe a torn write
        from kubetpu_torch.utils.leaderelection import FileLock, LeaseRecord
        flock = FileLock(str(lock))
        rec = LeaseRecord(holder="usurper", acquire_time=time.time(),
                          renew_time=time.time() + 3600, lease_duration=3600)
        flock._flocked(lambda: flock._write(rec))
        rc = proc.wait(timeout=60)
        assert rc == 1
        out, _ = proc.communicate(timeout=30)
        assert "lease lost" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
