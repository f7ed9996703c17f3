"""Run-provenance stamp for the port's benchmark output (`rlbench`): a
rate moves with the host's load between runs, so every output carries
the commit, the time, the host and its CPU count."""

from __future__ import annotations

import os
import subprocess
import time


def run_metadata() -> dict:
    def _git(*args):
        try:
            out = subprocess.run(
                ["git", *args],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True, text=True, timeout=10)
            return out.stdout.strip()
        except Exception:
            return ""

    return {
        "commit": _git("rev-parse", "--short", "HEAD"),
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
        "hostname": os.uname().nodename,
        "cpus": os.cpu_count(),
    }
