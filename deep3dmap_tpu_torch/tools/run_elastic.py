#!/usr/bin/env python
"""Elastic training supervisor (port of ``tools/run_elastic.py``): launch the
port's trainer with ``--resume-from auto``, watch its heartbeat, and restart
it from the latest checkpoint when it crashes or stalls.

    python -m deep3dmap_tpu_torch.tools.run_elastic --max-restarts 3 \\
        --stall-timeout 600 -- configs/neural_recon/scannet.py --work-dir results/neucon

- the child is ``python -m deep3dmap_tpu_torch.tools.train`` with the
  arguments after ``--``, in its own process group; a stalled group is
  killed as a whole (SIGTERM, then SIGKILL after 30 s), never by pattern;
- the heartbeat is the JSON file ``HeartbeatHook`` writes atomically (the
  trainer registers it when ``D3M_HEARTBEAT_FILE`` is set);
- every attempt resumes from the newest checkpoint, so the work lost is
  bounded by the checkpoint interval;
- exit codes: 0 when training finished, 1 when the restart budget is spent.

Training runs on the card: the supervisor raises at once on a machine
without one unless the trainer's arguments hold ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time


_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _heartbeat_age(path: str) -> float:
    try:
        with open(path) as f:
            data = json.load(f)
        return time.time() - float(data.get("time", 0.0))
    except (OSError, ValueError):
        return float("inf")


def _kill_group(proc, sig) -> None:
    try:
        os.killpg(os.getpgid(proc.pid), sig)
    except ProcessLookupError:
        pass


def run_once(train_args, hb_file: str, stall_timeout: float, poll: float, log) -> int:
    """One supervised attempt: the child's exit code, or -1 after killing
    its process group on a heartbeat stall."""
    env = dict(os.environ)
    env["D3M_HEARTBEAT_FILE"] = hb_file
    # the child imports this checkout's package, wherever it is started
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "deep3dmap_tpu_torch.tools.train"] + train_args
    log(f"launch: {' '.join(cmd)}")
    proc = subprocess.Popen(cmd, env=env, start_new_session=True)
    started = time.time()
    try:
        while True:
            rc = proc.poll()
            if rc is not None:
                return rc
            age = _heartbeat_age(hb_file)
            # a grace period before the first beat (imports, kernel builds)
            if age > stall_timeout and time.time() - started > stall_timeout:
                log(f"heartbeat stalled ({age:.0f}s > {stall_timeout:.0f}s); "
                    f"killing process group {proc.pid}")
                _kill_group(proc, signal.SIGTERM)
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    _kill_group(proc, signal.SIGKILL)
                    proc.wait()
                return -1
            time.sleep(poll)
    except BaseException:
        _kill_group(proc, signal.SIGTERM)
        proc.wait()
        raise


def _train_device(train_args) -> str:
    for i, a in enumerate(train_args):
        if a == "--device" and i + 1 < len(train_args):
            return train_args[i + 1]
        if a.startswith("--device="):
            return a.split("=", 1)[1]
    return "cuda"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--stall-timeout", type=float, default=600.0,
                    help="seconds without a heartbeat before the trainer is "
                         "declared hung and restarted")
    ap.add_argument("--poll", type=float, default=5.0)
    ap.add_argument("--backoff", type=float, default=10.0,
                    help="seconds to wait before a restart")
    ap.add_argument("--heartbeat-file", default=None)
    ap.add_argument("train_args", nargs=argparse.REMAINDER,
                    help="-- then everything tools/train.py takes (config first)")
    args = ap.parse_args(argv)

    train_args = [a for a in args.train_args if a != "--"]
    if not train_args:
        ap.error("pass tools/train.py arguments after --")
    from ..utils.device import resolve_device

    resolve_device(_train_device(train_args))
    if "--resume-from" not in train_args:
        train_args += ["--resume-from", "auto"]
    hb_file = args.heartbeat_file or os.path.join(
        tempfile.gettempdir(), f"d3m_heartbeat_{os.getpid()}.json")

    def log(msg):
        print(f"[run_elastic] {msg}", flush=True)

    attempts = 0
    while True:
        rc = run_once(train_args, hb_file, args.stall_timeout, args.poll, log)
        if rc == 0:
            log("training finished")
            return 0
        attempts += 1
        reason = "stall" if rc == -1 else f"exit code {rc}"
        if attempts > args.max_restarts:
            log(f"{reason}; restart budget ({args.max_restarts}) exhausted")
            return 1
        log(f"{reason}; restart {attempts}/{args.max_restarts} "
            f"in {args.backoff:.0f}s (resume from latest checkpoint)")
        time.sleep(args.backoff)


if __name__ == "__main__":
    sys.exit(main())
