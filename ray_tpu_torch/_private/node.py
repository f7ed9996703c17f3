"""Node bootstrap: spawn/stop the GCS and raylet service processes
(reference: python/ray/node.py:52 Node, start_head_processes :854,
start_ray_processes :875; python/ray/_private/services.py spawners)."""

from __future__ import annotations

import atexit
import json
import logging
import os
import shutil
import signal
import subprocess
import sys
import time
import uuid

from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.object_store import (default_store_root,
                                                  session_root)

logger = logging.getLogger("ray_tpu_torch.node")


def new_session_dir() -> str:
    base = session_root()
    session = f"session_{time.strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:8]}"
    path = os.path.join(base, session)
    os.makedirs(os.path.join(path, "logs"), exist_ok=True)
    return path


def _wait_ready(ready_file: str, proc: subprocess.Popen, what: str,
                timeout: float = 30.0) -> str:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(ready_file):
            with open(ready_file) as f:
                return f.read().strip()
        if proc.poll() is not None:
            raise RuntimeError(
                f"{what} exited with code {proc.returncode} during startup")
        time.sleep(0.02)
    raise TimeoutError(f"{what} did not become ready in {timeout}s")


class ServiceProcess:
    def __init__(self, name: str, proc: subprocess.Popen):
        self.name = name
        self.proc = proc

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self, sig=signal.SIGKILL):
        if self.alive():
            try:
                os.killpg(os.getpgid(self.proc.pid), sig)
            except (ProcessLookupError, PermissionError):
                try:
                    self.proc.kill()
                except ProcessLookupError:
                    pass
        try:
            self.proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            pass


def _spawn(cmd: list[str], config: Config, name: str) -> ServiceProcess:
    env = dict(os.environ)
    env.update(config.child_env())
    # `python -m ray_tpu_torch...` children must import the package
    # whatever the caller's cwd
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    existing = env.get("PYTHONPATH")
    if pkg_root not in (existing or "").split(os.pathsep):
        env["PYTHONPATH"] = (pkg_root + os.pathsep + existing
                             if existing else pkg_root)
    proc = subprocess.Popen(
        cmd, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        start_new_session=True)
    return ServiceProcess(name, proc)


def start_gcs(session_dir: str, config: Config) -> tuple[ServiceProcess, str]:
    ready = os.path.join(session_dir, f"gcs_ready_{uuid.uuid4().hex[:6]}")
    log_file = os.path.join(session_dir, "logs", "gcs_server.log")
    cmd = [
        sys.executable, "-m", "ray_tpu_torch.gcs.server",
        "--ready-file", ready,
        "--log-file", log_file,
        "--uds-dir", os.path.join(session_dir, "sock"),
    ]
    svc = _spawn(cmd, config, "gcs_server")
    actual_port = _wait_ready(ready, svc.proc, "gcs_server")
    return svc, f"{config.node_ip_address}:{actual_port}"


def start_raylet(session_dir: str, gcs_address: str, config: Config, *,
                 num_cpus: float | None = None, num_gpus: float = 0,
                 resources: dict | None = None, labels: dict | None = None
                 ) -> tuple[ServiceProcess, str, NodeID, str]:
    node_id = NodeID.from_random()
    ready = os.path.join(session_dir, f"raylet_ready_{node_id.hex()[:8]}")
    log_file = os.path.join(session_dir, "logs",
                            f"raylet-{node_id.hex()[:8]}.log")
    store_root = os.path.join(
        default_store_root(session_dir, config.object_store_memory),
        node_id.hex()[:8])
    cmd = [
        sys.executable, "-m", "ray_tpu_torch.raylet.raylet",
        "--gcs-address", gcs_address,
        "--session-dir", session_dir,
        "--store-root", store_root,
        "--node-id", node_id.hex(),
        "--resources", json.dumps(resources or {}),
        "--labels", json.dumps(labels or {}),
        "--ready-file", ready,
        "--log-file", log_file,
    ]
    if num_cpus is not None:
        cmd += ["--num-cpus", str(num_cpus)]
    if num_gpus:
        cmd += ["--num-gpus", str(num_gpus)]
    cmd += ["--is-head"]
    svc = _spawn(cmd, config, f"raylet-{node_id.hex()[:8]}")
    address = _wait_ready(ready, svc.proc, "raylet")
    return svc, address, node_id, store_root


class Node:
    """A local cluster: the GCS and one raylet."""

    def __init__(self, *, config: Config, num_cpus=None, num_gpus=0,
                 resources=None, labels=None):
        self.config = config
        self.session_dir = new_session_dir()
        self.processes: list[ServiceProcess] = []
        gcs_proc, self.gcs_address = start_gcs(self.session_dir, config)
        self.processes.append(gcs_proc)
        raylet_proc, raylet_addr, node_id, store_root = start_raylet(
            self.session_dir, self.gcs_address, config,
            num_cpus=num_cpus, num_gpus=num_gpus, resources=resources,
            labels=labels)
        self.processes.append(raylet_proc)
        self.raylet_address = raylet_addr
        self.node_id = node_id
        self.store_root = store_root
        atexit.register(self.kill_all_processes)

    def kill_all_processes(self):
        for svc in reversed(self.processes):
            svc.kill()
        self.processes.clear()
        # the node's object-store arena (a file under /dev/shm) dies with
        # its processes, so no segment outlives the session
        arena = os.path.dirname(os.path.dirname(self.store_root))
        shutil.rmtree(arena, ignore_errors=True)
        try:  # the /dev/shm directory of this tempdir, once it is empty
            os.rmdir(os.path.dirname(arena))
        except OSError:
            pass
