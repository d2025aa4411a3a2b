"""Multi-process entry (port of ``light_unet_tpu/parallel/distributed.py:37-85``).

The JAX package enters ``jax.distributed.initialize`` before first device
use; here every process is one rank of a ``torch.distributed`` process
group, one GPU each, and ``maybe_distributed_init`` makes that group from
the same four ``tpu:`` fields:

* ``coordinator_address`` -> the rendezvous (``host:port`` becomes
  ``tcp://host:port``; an address with a scheme, such as ``file://...``, is
  taken as it is);
* ``num_processes`` -> ``world_size``, ``process_id`` -> ``rank``;
* ``distributed: true`` with none of them set reads what ``torchrun`` sets
  (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; the device
  index comes from ``LOCAL_RANK``), the counterpart of a TPU pod's
  autodetection.

A process that ``torchrun`` started with ``WORLD_SIZE`` > 1 is one rank of
a multi-process run even when the config does not say
``distributed: true`` (``configs/unet_fl70_pod.yaml`` does not: in JAX
that config takes every local chip from one process).  It never runs as an
independent single-process job, which would put every process on
``cuda:0`` writing the same files.

The backend follows the device: NCCL for CUDA, gloo for the CPU.  The
``backend`` and ``timeout`` arguments exist for a group of several ranks
on one card (NCCL refuses two ranks on one GPU) and for tests; no YAML
field selects them.

Beside the default group every rank holds a gloo group with a long
timeout, the *wait group*.  Ranks meet on it wherever one of them may be
busy for long on its own: ``barrier`` (the CLI's stage barrier: rank 0
runs split, preprocess and evaluate alone, which on a large cohort takes
longer than the collective backend's default deadline), and the run-end
barrier, at which a rank that the mesh leaves out (``parallel/mesh.py``)
waits until every other rank reaches it.  ``finish`` (called by whoever
made the group, and at interpreter exit) is that barrier, then the groups
are destroyed.
"""

from __future__ import annotations

import atexit
import datetime
import logging
import os
from typing import Mapping, Optional, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# a rank waits this long at most for another rank's stage, or for the run to end
WAIT_TIMEOUT = datetime.timedelta(days=30)

# process-wide, like the default process group it belongs to: the wait
# group, and the ranks parked at the run-end barrier
_wait_group = None
_parked: set = set()


def is_distributed_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def launched_by_torchrun(env: Optional[Mapping[str, str]] = None) -> bool:
    """True in a process that ``torchrun`` started as one of several."""
    env = os.environ if env is None else env
    return "TORCHELASTIC_RUN_ID" in env and int(env.get("WORLD_SIZE") or 1) > 1


def wants_distributed(tpu_cfg) -> bool:
    return (bool(getattr(tpu_cfg, "distributed", False))
            or (getattr(tpu_cfg, "num_processes", None) or 0) > 1
            or launched_by_torchrun())


def init_args(tpu_cfg, env: Optional[Mapping[str, str]] = None) -> Tuple[str, int, int]:
    """(init_method, world_size, rank) from the ``tpu:`` fields, else from
    torchrun's environment; raises ``ValueError`` naming what is missing."""
    env = os.environ if env is None else env
    addr = getattr(tpu_cfg, "coordinator_address", None)
    if addr:
        init_method = addr if "://" in addr else f"tcp://{addr}"
    elif env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    else:
        raise ValueError("tpu.distributed: set tpu.coordinator_address, or launch with torchrun "
                         "(MASTER_ADDR and MASTER_PORT)")
    world = getattr(tpu_cfg, "num_processes", None) or env.get("WORLD_SIZE")
    rank = getattr(tpu_cfg, "process_id", None)
    rank = env.get("RANK") if rank is None else rank
    if world is None or rank is None:
        raise ValueError("tpu.distributed: set tpu.num_processes and tpu.process_id, or launch "
                         "with torchrun (WORLD_SIZE and RANK)")
    return init_method, int(world), int(rank)


def local_rank(rank: int, env: Optional[Mapping[str, str]] = None) -> int:
    """This process's device index on its host: ``LOCAL_RANK`` (torchrun),
    else ``rank`` modulo the host's CUDA device count."""
    env = os.environ if env is None else env
    if env.get("LOCAL_RANK") is not None:
        return int(env["LOCAL_RANK"])
    return rank % max(1, torch.cuda.device_count())


def rank_device(tpu_cfg, device: str) -> str:
    """The device this process runs on: in a multi-process run a bare
    ``"cuda"`` is this rank's card, ``cuda:LOCAL_RANK``; any other device
    (an index, the CPU) is taken as it is."""
    if device != "cuda" or not wants_distributed(tpu_cfg):
        return device
    return f"cuda:{local_rank(init_args(tpu_cfg)[2])}"


def world_rank() -> int:
    return dist.get_rank() if is_distributed_initialized() else 0


def maybe_distributed_init(tpu_cfg, device="cuda", backend: Optional[str] = None,
                           timeout: Optional[datetime.timedelta] = None) -> bool:
    """Make the process group, and beside it the wait group, if the config
    or ``torchrun`` asks for a multi-process run.

    Call before any device use (the CLI does, before its first stage).
    Returns True when the process is part of a multi-process run.
    Idempotent: with a group already made, it returns True at once.
    ``timeout`` is the default group's (None: the backend's default)."""
    global _wait_group
    if not wants_distributed(tpu_cfg):
        return False
    if is_distributed_initialized():
        return True
    device = torch.device(device)
    init_method, world, rank = init_args(tpu_cfg)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=timeout)
    _wait_group = dist.new_group(backend="gloo", timeout=WAIT_TIMEOUT)
    logger.info("process group up: rank %d of %d, backend %s, device %s", rank, world, backend,
                device)
    if rank == 0 and not getattr(tpu_cfg, "distributed", False) and launched_by_torchrun():
        print(f"torchrun started {world} processes: one job of {world} ranks "
              f"(tpu.distributed taken as true)", flush=True)
    return True


def live_ranks() -> list:
    """The world's ranks not parked at the run-end barrier ([0] alone)."""
    if not is_distributed_initialized():
        return [0]
    return [r for r in range(dist.get_world_size()) if r not in _parked]


def park(left_out) -> None:
    """Every live rank calls this when a mesh leaves ``left_out`` out: it
    records who is parked.  A left-out rank then waits at the run-end
    barrier and leaves with ``SystemExit(0)``."""
    left_out = set(left_out)
    if not left_out:
        return
    if not _parked:
        atexit.register(finish)
    _parked.update(left_out)
    me = dist.get_rank()
    if me in left_out:
        print(f"rank {me}: outside the mesh of ranks {live_ranks()}; idling at the run-end "
              f"barrier until the run ends", flush=True)
        finish()
        raise SystemExit(0)


def barrier() -> None:
    """Wait for every live rank on the wait group, with no deadline from the
    collective backend however long one rank's stage takes (a no-op in a
    single process)."""
    if not is_distributed_initialized():
        return
    if not _parked:
        dist.barrier(group=_wait_group)
        return
    dist.barrier(group=dist.new_group(live_ranks(), backend="gloo", timeout=WAIT_TIMEOUT,
                                      use_local_synchronization=True))


def finish() -> None:
    """End this process's part of the run: wait at the run-end barrier (when
    a mesh left ranks out), destroy the CUDA graphs (those that captured
    NCCL collectives must go before the communicator), then destroy the
    process group.  Idempotent."""
    global _wait_group
    if not is_distributed_initialized():
        return
    group, _wait_group = _wait_group, None
    if _parked:
        dist.barrier(group=group)
    _parked.clear()
    from light_unet_tpu_torch.utils import graphs

    graphs.release()
    dist.destroy_process_group()
