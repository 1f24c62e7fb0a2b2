"""Multi-process initialization and mesh construction (port of
`mpbp_tpu/parallel/distributed.py`).

The JAX package is single-controller: one `jax.distributed.initialize` a
process, after which XLA distributes every program over the global device
list. The port is SPMD over `torch.distributed`: one process (rank) a
device, NCCL between CUDA devices and gloo between CPU processes. Every
rank runs the same solver on its band of grid rows (`parallel/sharding.py`)
and meets the others only in the halo exchanges and all-reduces.

Launch contracts, tried in this order:
  1. the JAX package's own: coordinator_address / num_processes /
     process_id, or the environment variables MPBP_COORDINATOR,
     MPBP_NUM_PROCS and MPBP_PROC_ID. The coordinator is "host:port" of
     rank 0, or an init-method URL ("tcp://...", "file://...");
  2. torch's `env://` (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), which
     `python -m torch.distributed.run` sets;
  3. neither: an explicit group of one rank, whose ring neighbour is
     itself.
The backend follows the device, never the other way round: `nccl` for
"cuda", `gloo` for "cpu". A CUDA run that finds another backend already
initialized raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device) -> str:
    """The collective backend of a device: nccl for cuda, gloo for cpu."""
    kind = torch.device(device).type
    if kind not in _BACKENDS:
        raise ValueError(f"no collective backend for device {device!r} "
                         "(cuda or cpu)")
    return _BACKENDS[kind]


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None, *,
                     device: torch.device | str = "cuda") -> dict:
    """Join (or open) this process's default process group.

    Arguments default to the MPBP_* environment variables, then to torch's
    env:// contract, then to a group of one rank (module docstring). On
    "cuda" the rank's device is `local_device_ids[0]`, else LOCAL_RANK,
    else rank mod the device count, and the NCCL communicator is created
    here, so a failed NCCL init raises here. Idempotent: a second call
    checks the backend and returns the summary. Returns
    {process_id, num_processes, global_devices, local_devices, backend}."""
    backend = backend_for(device)
    coordinator_address = coordinator_address or os.environ.get(
        "MPBP_COORDINATOR")
    if num_processes is None and "MPBP_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["MPBP_NUM_PROCS"])
    if process_id is None and "MPBP_PROC_ID" in os.environ:
        process_id = int(os.environ["MPBP_PROC_ID"])

    if not dist.is_initialized():
        explicit = coordinator_address is not None or num_processes is not None
        if explicit and None in (coordinator_address, num_processes,
                                 process_id):
            raise ValueError("the MPBP contract needs coordinator_address, "
                             "num_processes and process_id together")
        env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
        rank = (process_id if explicit
                else int(os.environ["RANK"]) if env else 0)
        kw = {}
        if backend == "nccl":
            if local_device_ids:
                local = int(local_device_ids[0])
            elif "LOCAL_RANK" in os.environ:
                local = int(os.environ["LOCAL_RANK"])
            else:
                local = rank % torch.cuda.device_count()
            torch.cuda.set_device(local)
            kw["device_id"] = torch.device("cuda", local)
        if explicit:
            url = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
            dist.init_process_group(backend, init_method=url,
                                    world_size=num_processes, rank=rank, **kw)
        elif env:
            dist.init_process_group(backend, init_method="env://", **kw)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, **kw)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"a {dist.get_backend()} process group is open; "
                           f"device {device!r} needs {backend}")
    world = dist.get_world_size()
    return {"process_id": dist.get_rank(), "num_processes": world,
            "global_devices": world, "local_devices": 1,
            "backend": backend}


def device_type() -> str:
    """The device type of the open default group: 'cuda' under NCCL,
    'cpu' under gloo."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def fetch_replicated(x) -> np.ndarray:
    """Host value of a value every rank holds alike (solver scalars:
    iters, relres, converged; a gathered solution)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def global_mesh_1d(axis: str = "x"):
    """1-D mesh over every rank, in rank order: a contiguous band of grid
    rows a rank, and with ranks numbered host-major each host owns a
    contiguous super-band (the +-1-row halos cross hosts only at the host
    seams)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type(), (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def global_mesh_2d(axes: tuple[str, str] = ("dcn", "ici")):
    """2-D (hosts, devices-per-host) mesh; LOCAL_WORLD_SIZE (set by
    `torch.distributed.run`) gives the ranks a host, by default all of
    them on one. Ranks are host-major, so row r * per_host + d places the
    host seams on the `dcn` boundaries."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per_host:
        raise ValueError(f"{world} ranks do not split into hosts of "
                         f"{per_host}")
    return init_device_mesh(device_type(), (world // per_host, per_host),
                            mesh_dim_names=tuple(axes))
