"""Launch a cluster of port processes for the CPU tests (not a test file).

Each process gets ``PDDL_COORDINATOR`` / ``PDDL_NUM_PROCESSES`` /
``PDDL_PROCESS_ID`` (discovery step 2 of ``pddl_tpu_torch.core.dist``) and
opens a gloo group on localhost. The cluster has one deadline: when it
runs out every survivor is killed (a process blocked in a collective
against a dead peer ignores SIGTERM), so a hung rendezvous costs the
deadline, never the suite's limit. No process group is opened in the
pytest process itself.
"""

import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Cluster:
    """``n`` processes of ``python script *args``, started at once."""

    def __init__(self, script: str, n: int, *args: str, **extra_env):
        port = free_port()
        base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        base.update(PYTHONPATH=REPO + os.pathsep + base.get("PYTHONPATH", ""),
                    OMP_NUM_THREADS="1",
                    **{k: str(v) for k, v in extra_env.items()})
        self.procs = []
        try:
            for rank in range(n):
                env = dict(base, PDDL_COORDINATOR=f"127.0.0.1:{port}",
                           PDDL_NUM_PROCESSES=str(n),
                           PDDL_PROCESS_ID=str(rank))
                self.procs.append(subprocess.Popen(
                    [sys.executable, script, *args], env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
        except BaseException:
            self.kill()
            raise

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def wait(self, timeout: float = 240.0) -> list:
        """Every process's output under one deadline; on timeout every
        survivor is killed. Raises unless every process exited 0."""
        deadline = time.monotonic() + timeout
        outputs = []
        try:
            for p in self.procs:
                try:
                    out, _ = p.communicate(
                        timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    self.kill()
                    out, _ = p.communicate()
                outputs.append(out)
        finally:
            self.kill()
        for rank, (p, out) in enumerate(zip(self.procs, outputs)):
            if p.returncode != 0:
                raise AssertionError(
                    f"process {rank} of {len(self.procs)} exited "
                    f"{p.returncode}:\n{out[-4000:]}")
        return outputs
