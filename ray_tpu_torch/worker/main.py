"""Worker process entrypoint (reference:
python/ray/workers/default_worker.py): connect to the local raylet, register
into its pool, and run the task execution loop."""

from __future__ import annotations

import argparse
import logging


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--raylet-address", required=True)
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--store-root", required=True)
    parser.add_argument("--log-file", default=None)
    args = parser.parse_args()

    from ray_tpu_torch._private.config import Config, get_config, set_config
    from ray_tpu_torch._private.core_worker import WORKER, CoreWorker
    from ray_tpu_torch._private.log_utils import setup_process_logging

    setup_process_logging("worker", args.log_file)
    set_config(Config.load())

    cw = CoreWorker(
        mode=WORKER,
        raylet_address=args.raylet_address,
        gcs_address=args.gcs_address,
        session_dir=args.session_dir,
        store_root=args.store_root,
        config=get_config(),
    )
    # print()/stderr from task code streams to the driver console
    # (reference: log_monitor.py:48 republishing).
    from ray_tpu_torch._private.log_utils import install_stdout_forwarder

    install_stdout_forwarder(cw)
    logging.getLogger("ray_tpu_torch.worker").info(
        "worker %s registered with raylet %s",
        cw.worker_id.hex()[:8], args.raylet_address)
    cw.run_task_execution_loop()


if __name__ == "__main__":
    main()
