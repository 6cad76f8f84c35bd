"""Start N processes of one command on this host, as `torchrun
--nproc_per_node N` starts them, and wait for all of them.

Each process gets torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR=127.0.0.1, a free MASTER_PORT), which
`parallel.mesh.init_distributed` reads, and one intra-op thread. The
launch has a time limit of its own: when it passes, or when one process
fails, every process is killed and `launch` raises with the tails of
their outputs, so a hung rendezvous fails its caller instead of waiting
forever. Used by `tools.multihost_demo`, `parallel.dryrun` and the CPU
tests of the parallel paths; from a shell, torchrun does the same.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _tail(text: str, n: int = 4000) -> str:
    return text[-n:]


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


def launch(argv: Sequence[str], nprocs: int, *, timeout: float,
           env: Optional[Dict[str, str]] = None,
           cwd: Optional[str] = None) -> List[str]:
    """Run `python <argv>` as ranks 0..nprocs-1; returns each rank's
    output (stdout and stderr). Raises RuntimeError if a rank exits with
    another code than 0, TimeoutError after `timeout` seconds; either way
    no process is left running."""
    port = free_port()
    logs, procs = [], []
    try:
        for rank in range(nprocs):
            e = dict(os.environ)
            e.update(env or {})
            e.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     RANK=str(rank), WORLD_SIZE=str(nprocs),
                     LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nprocs),
                     OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
            e["PYTHONPATH"] = os.pathsep.join(
                [str(ROOT)] + [x for x in [e.get("PYTHONPATH")] if x])
            log = tempfile.TemporaryFile(mode="w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, *argv], stdout=log, stderr=subprocess.STDOUT,
                env=e, cwd=cwd or str(ROOT), start_new_session=True))
        deadline = time.monotonic() + timeout
        failed = None
        while any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if failed is not None or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        timed_out = any(p.poll() is None for p in procs) and failed is None
        _kill(procs)
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
        if timed_out:
            raise TimeoutError(
                f"launch: {nprocs} processes of {list(argv)} still ran "
                f"after {timeout} s; killed\n"
                + "\n".join(f"--- rank {r}\n{_tail(o)}"
                            for r, o in enumerate(outs)))
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(
                f"launch: rank(s) {bad} of {list(argv)} failed (rc "
                f"{[procs[r].returncode for r in bad]})\n"
                + "\n".join(f"--- rank {r}\n{_tail(outs[r])}" for r in bad))
        return outs
    finally:
        _kill(procs)
        for log in logs:
            log.close()

