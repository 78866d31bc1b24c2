"""Data-parallel ranks of the port for the tests: one process per rank on
the CPU, in one gloo group.

    spawn(module, function, world, workdir) -> [rank 0's result, ...]

(or ``start(...)``, which returns at once, and ``.results()`` later)
starts ``python tests/_torch_dp.py MODULE FUNCTION RANK WORLD WORKDIR`` for
every rank at once.  Each child puts ``tests/`` and the repository root on
its path, runs one intra-op thread, starts the group through a file store
in ``WORKDIR`` (no port: each spawn has its own directory, so concurrent
spawns cannot take each other's rendezvous), where a collective that waits
longer than ``COLLECTIVE_TIMEOUT`` fails, calls
``MODULE.FUNCTION(rank, world, workdir)`` and pickles what it returns to
``WORKDIR/rank{RANK}.pkl``.  The parent waits at most ``timeout`` seconds
for all of them, kills the others as soon as one fails, and raises with the
failed rank's output; so a hung rank fails its test instead of running the
suite into its time limit.  The modules a child imports should not import
JAX at the top (the children never need it).
"""

import datetime
import importlib
import os
import pickle
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)
STORE = "pg_store"


def free_port() -> int:
    """A port that was free a moment ago (for a one-rank ``env://`` group;
    the spawned ranks meet through a file instead)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """The processes of one spawn; :meth:`results` waits for them."""

    def __init__(self, module, function, world, workdir, timeout):
        self.what = f"{module}.{function} on {world} ranks"
        self.workdir = str(workdir)
        self.timeout = timeout
        os.makedirs(self.workdir, exist_ok=True)
        store = self._path(STORE)
        if os.path.exists(store):       # a finished spawn's, in this dir
            os.remove(store)
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                            "MASTER_ADDR", "MASTER_PORT")}
        env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        self.deadline = time.monotonic() + timeout
        self.procs, self.logs = [], []
        for rank in range(world):
            log = open(self._path(f"rank{rank}.log"), "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), module, function,
                 str(rank), str(world), self.workdir],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT))

    def _path(self, name):
        return os.path.join(self.workdir, name)

    def results(self) -> list:
        """Every rank's result, in rank order; raises with the output of
        the first rank that failed (or of rank 0 on a timeout)."""
        procs = self.procs
        try:
            while any(p.poll() is None for p in procs) and not any(
                    p.returncode not in (None, 0) for p in procs) \
                    and time.monotonic() < self.deadline:
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in self.logs:
                log.close()
        codes = [p.returncode for p in procs]
        if any(codes):
            rank = next((r for r, c in enumerate(codes) if c > 0), 0)
            with open(self._path(f"rank{rank}.log")) as f:
                tail = f.read()[-6000:]
            raise AssertionError(
                f"{self.what}: exit codes {codes} (a negative one is a "
                f"kill, after {self.timeout} s at most); rank {rank}'s "
                f"output:\n{tail}")
        out = []
        for rank in range(len(procs)):
            with open(self._path(f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def start(module: str, function: str, world: int, workdir,
          timeout=240) -> Ranks:
    """Start the ranks and return at once."""
    return Ranks(module, function, world, workdir, timeout)


def spawn(module: str, function: str, world: int, workdir,
          timeout=240) -> list:
    """Start the ranks and wait for their results."""
    return start(module, function, world, workdir, timeout).results()


def _child(module, function, rank, world, workdir):
    sys.path[:0] = [ROOT, HERE]
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, STORE),
        rank=rank, world_size=world, timeout=COLLECTIVE_TIMEOUT)
    try:
        result = getattr(importlib.import_module(module), function)(
            rank, world, workdir)
        path = os.path.join(workdir, f"rank{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    m, fn, r, w, d = sys.argv[1:6]
    _child(m, fn, int(r), int(w), d)
