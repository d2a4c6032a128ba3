"""The port's standalone manager as a child process, for the conformance
programs: `python -m kubeflow_tpu_torch.main ARGS` started from the root
of the checkout, its output collected on a thread (so a full pipe never
stalls it), and killed when the `with` block ends, whichever way it ends.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    """A loopback TCP port nobody holds right now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ManagerProcess:
    def __init__(self, args: list[str], env: dict | None = None):
        self.args = list(args)
        self.env = dict(os.environ, **(env or {}))
        self.env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(ROOT), self.env.get("PYTHONPATH", "")) if p)
        self.lines: list[str] = []
        self._cond = threading.Condition()
        self.proc: subprocess.Popen | None = None

    def __enter__(self) -> "ManagerProcess":
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.main", *self.args],
            cwd=ROOT, env=self.env, stdin=subprocess.DEVNULL,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        threading.Thread(target=self._drain, daemon=True).start()
        return self

    def _drain(self) -> None:
        for line in self.proc.stdout:
            with self._cond:
                self.lines.append(line.rstrip("\n"))
                self._cond.notify_all()
        with self._cond:
            self._cond.notify_all()

    def wait_for(self, prefix: str, timeout: float = 60.0) -> str:
        """The rest of the first output line that starts with `prefix`;
        raises if the manager exits or stays silent past `timeout`."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                for line in self.lines:
                    if line.startswith(prefix):
                        return line[len(prefix):]
                left = deadline - time.monotonic()
                if self.proc.poll() is not None or left <= 0:
                    raise RuntimeError(
                        f"manager never printed {prefix!r} (exit "
                        f"{self.proc.poll()}); its output:\n"
                        + "\n".join(self.lines[-40:]))
                self._cond.wait(min(left, 0.2))

    def __exit__(self, *exc) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
