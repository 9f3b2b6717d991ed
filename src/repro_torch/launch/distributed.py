"""Multi-process runtime for the cohort trainer: one process per rank,
each on its own device, joined by ``torch.distributed``; counterpart of
repro/launch/distributed.py.

Importing this module starts nothing. The pieces:

  ``maybe_initialize()``   reads the ``REPRO_DIST_*`` environment and,
      when it is present, joins the job BEFORE the first device query:
      ``torch.distributed.init_process_group`` on a TCP store at the
      coordinator's address, with an explicit timeout, so a collective
      that hangs raises instead of waiting forever. The backend is NCCL
      when each rank has a card of its own and gloo on the CPU. Two ranks
      on one card cannot share NCCL (it refuses a duplicate GPU), so that
      layout runs on gloo, and only when the caller names it
      (``REPRO_DIST_BACKEND=gloo``). A no-op (returning None) outside a
      spawned job, so single-process entry points call it
      unconditionally.

  ``spawn_local(argv, n)``   the single-machine n-process spawner: it
      hosts the job's TCP store itself (bound to a free port, so no port
      can be taken between choosing and binding it), re-executes ``argv``
      n times with the contract set, and raises with the children's tails
      as soon as one child fails, after killing the others at once, so no
      peer waits on a dead one until its timeout.

  ``is_coordinator()``, ``barrier(name)``, ``kv_allmax(name, value)``
      rank 0 gates side effects (checkpoint writes, the health log);
      ``barrier`` and ``kv_allmax`` go through the job's STORE, never
      through collectives, as the reference's go through its key-value
      store: ``kv_allmax`` is called from the staging producer thread,
      where a collective would interleave with the main thread's and
      hang. Each thread talks to the store over a connection of its own.
"""
from __future__ import annotations

import atexit
import datetime
import gc
import os
import socket
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# the environment contract between spawn_local and maybe_initialize
ENV_COORD = "REPRO_DIST_COORD"            # host:port of the job's store
ENV_NPROCS = "REPRO_DIST_NPROCS"
ENV_PID = "REPRO_DIST_PID"
# cards the ranks of one host spread over: a rank takes
# cuda:(pid % local devices); default, one card a rank
ENV_LOCAL_DEVICES = "REPRO_DIST_LOCAL_DEVICES"
ENV_BACKEND = "REPRO_DIST_BACKEND"        # "gloo" or "nccl"; named, or chosen
# "1": the spawner hosts the store, and every rank is its client
ENV_STORE_HOSTED = "REPRO_DIST_STORE_HOSTED"

DEFAULT_TIMEOUT_S = 120.0


@dataclass(frozen=True)
class DistContext:
    """What maybe_initialize() resolved: this process's place in the
    job."""
    coordinator: str
    num_processes: int
    process_id: int
    local_devices: int
    backend: Optional[str] = None

    @property
    def local_rank(self) -> int:
        return self.process_id % self.local_devices


def dist_env(environ=None) -> Optional[DistContext]:
    """Parse the REPRO_DIST_* contract; None outside a distributed job."""
    env = os.environ if environ is None else environ
    coord = env.get(ENV_COORD)
    if not coord:
        return None
    n = int(env.get(ENV_NPROCS, "1"))
    return DistContext(coordinator=coord, num_processes=n,
                       process_id=int(env.get(ENV_PID, "0")),
                       local_devices=int(env.get(ENV_LOCAL_DEVICES, n)),
                       backend=env.get(ENV_BACKEND) or None)


class _Job:
    """The joined job's store address and each thread's connection to
    it (set by maybe_initialize, once a process)."""

    def __init__(self, host: str, port: int, timeout_s: float):
        self.host, self.port, self.timeout_s = host, port, timeout_s
        self._local = threading.local()

    def store(self) -> dist.TCPStore:
        store = getattr(self._local, "store", None)
        if store is None:
            store = self._local.store = dist.TCPStore(
                self.host, self.port, None, False,
                datetime.timedelta(seconds=self.timeout_s),
                wait_for_workers=False)
        return store


_job: Optional[_Job] = None


def _choose_backend(ctx: DistContext) -> str:
    if not torch.cuda.is_available():
        return "gloo"
    if torch.cuda.device_count() < ctx.local_devices:
        raise RuntimeError(
            f"{ctx.local_devices} ranks on this host but "
            f"{torch.cuda.device_count()} card(s): NCCL needs a card a "
            f"rank; ranks that share a card must name gloo "
            f"({ENV_BACKEND}=gloo and {ENV_LOCAL_DEVICES}=<cards>)")
    return "nccl"


def maybe_initialize(timeout_s: float = DEFAULT_TIMEOUT_S
                     ) -> Optional[DistContext]:
    """Join the job the environment describes, once; returns its
    DistContext, or None outside a distributed job. On a machine with a
    card, the rank's card (cuda:local_rank) becomes the current device,
    so ``device="cuda"`` means it from here on."""
    global _job
    ctx = dist_env()
    if ctx is None:
        return None
    if _job is None:
        backend = ctx.backend or _choose_backend(ctx)
        if torch.cuda.is_available():
            torch.cuda.set_device(ctx.local_rank)
        host, port = ctx.coordinator.rsplit(":", 1)
        hosted = os.environ.get(ENV_STORE_HOSTED) == "1"
        timeout = datetime.timedelta(seconds=timeout_s)
        store = dist.TCPStore(host, int(port), ctx.num_processes,
                              ctx.process_id == 0 and not hosted, timeout,
                              wait_for_workers=False)
        dist.init_process_group(backend, store=store,
                                rank=ctx.process_id,
                                world_size=ctx.num_processes,
                                timeout=timeout)
        _job = _Job(host, int(port), timeout_s)
        _job._local.store = store
        atexit.register(_leave)
    return DistContext(ctx.coordinator, ctx.num_processes, ctx.process_id,
                       ctx.local_devices, dist.get_backend())


def _leave() -> None:
    """Tear the job down before the interpreter does. Left to the
    interpreter's exit, the groups and the store clients can be
    destroyed with a thread still joinable, which aborts the rank
    (SIGABRT) after its work is done; so can a group that the program
    still holds a reference to at exit."""
    global _job
    gc.collect()          # groups held only by unreachable cycles
    if dist.is_initialized():
        dist.destroy_process_group()
    _job = None


def process_count() -> int:
    """Ranks in the job; 1 outside one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    """True on rank 0 and in any single-process run: the one process
    that writes checkpoints and the health log."""
    return process_index() == 0


def _store() -> dist.TCPStore:
    if _job is None:
        raise RuntimeError("the job's store needs maybe_initialize() to "
                           "have joined a job (no REPRO_DIST_* environment "
                           "was found)")
    return _job.store()


def barrier(name: str, *, timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Every rank waits at ``name`` until all have reached it, through the
    store: each publishes <name>/<rank>, then waits for every peer's key.
    ``name`` must be unique to its synchronization point. A no-op in a
    single process."""
    n = process_count()
    if n <= 1:
        return
    store = _store()
    store.set(f"repro/barrier/{name}/{process_index()}", "1")
    store.wait([f"repro/barrier/{name}/{peer}" for peer in range(n)],
               datetime.timedelta(seconds=timeout_s))


def kv_allmax(name: str, value: int, *,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """The max of a host-side int over the ranks, through the store (every
    rank publishes <name>/<rank> and reads every peer's); used where the
    ranks must agree on a host-side capacity, such as the cohort stack's
    minibatch bucket, from a thread that must not issue a collective.
    Identity in a single process."""
    n = process_count()
    if n <= 1:
        return int(value)
    store = _store()
    store.set(f"repro/allmax/{name}/{process_index()}", str(int(value)))
    keys = [f"repro/allmax/{name}/{peer}" for peer in range(n)]
    store.wait(keys, datetime.timedelta(seconds=timeout_s))
    return max(int(value), *(int(store.get(k)) for k in keys))


def free_port() -> int:
    """A port that was free when asked (a test's own listener; the
    spawner binds its store's port itself)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _read(path: str) -> str:
    with open(path, errors="replace") as fh:
        return fh.read()


def spawn_local(argv: Sequence[str], num_processes: int, *,
                env: Optional[dict] = None, timeout_s: float = 600.0,
                backend: Optional[str] = None,
                local_devices: Optional[int] = None,
                capture: bool = True):
    """Run ``argv`` as ``num_processes`` local processes forming one job
    (the stand-in for a multi-host launch: the store on 127.0.0.1, no
    outside network). The children must call ``maybe_initialize()``
    before their first device query.

    Each child gets the REPRO_DIST_* contract, ``env`` on top of this
    process's environment and one intra-op thread (``OMP_NUM_THREADS=1``
    unless ``env`` says otherwise), so n children do not oversubscribe
    the cores. ``backend`` names the process group's backend (gloo for
    ranks that share a card) and ``local_devices`` the cards they spread
    over.

    Returns [(returncode, stdout, stderr)] per child (outputs empty
    without ``capture``). The first child to fail, or the deadline,
    kills every other child at once and raises RuntimeError with the
    tails of the failed children's outputs."""
    store = dist.TCPStore("127.0.0.1", 0, None, True,
                          datetime.timedelta(seconds=timeout_s),
                          wait_for_workers=False)
    procs, logs = [], []
    try:
        with tempfile.TemporaryDirectory(prefix="repro_spawn_") as tmp:
            for pid in range(num_processes):
                child_env = dict(os.environ)
                child_env.update({"OMP_NUM_THREADS": "1",
                                  "MKL_NUM_THREADS": "1"})
                child_env.update(env or {})
                child_env.update({ENV_COORD: f"127.0.0.1:{store.port}",
                                  ENV_NPROCS: str(num_processes),
                                  ENV_PID: str(pid),
                                  ENV_STORE_HOSTED: "1"})
                if backend is not None:
                    child_env[ENV_BACKEND] = backend
                if local_devices is not None:
                    child_env[ENV_LOCAL_DEVICES] = str(local_devices)
                out = os.path.join(tmp, f"{pid}.out")
                err = os.path.join(tmp, f"{pid}.err")
                logs.append((out, err))
                with open(out, "w") as fo, open(err, "w") as fe:
                    procs.append(subprocess.Popen(
                        list(argv), env=child_env,
                        stdout=fo if capture else None,
                        stderr=fe if capture else None))
            deadline = time.monotonic() + timeout_s
            failed = []
            while True:
                codes = [p.poll() for p in procs]
                failed = [i for i, rc in enumerate(codes)
                          if rc is not None and rc != 0]
                if failed or all(rc == 0 for rc in codes):
                    break
                if time.monotonic() > deadline:
                    failed = [i for i, rc in enumerate(codes) if rc is None]
                    break
                time.sleep(0.05)
            timed_out = bool(failed) and procs[failed[0]].returncode is None
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            results = [(p.returncode,
                        _read(out) if capture else "",
                        _read(err) if capture else "")
                       for p, (out, err) in zip(procs, logs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        del store
    if failed:
        why = (f"timed out after {timeout_s} s" if timed_out
               else "failed")
        msgs = [f"child {i} exited {results[i][0]}\n--- stdout tail ---\n"
                f"{results[i][1][-2000:]}\n--- stderr tail ---\n"
                f"{results[i][2][-2000:]}" for i in failed]
        raise RuntimeError(f"spawn_local: {why}\n" + "\n".join(msgs))
    return results

