"""Multi-process start-up on `torch.distributed` (port of
`parallel/distributed.py`).

The reference runs one JAX process per host, each owning that host's
chips; `jax.distributed.initialize` joins the processes.  The port runs one
process per rank, each owning ONE device: on cards, GPU `LOCAL_RANK` of its
host (NCCL); on the CPU, gloo.  The reference's variables map to torch's:

    JAX_COORDINATOR_ADDRESS  ->  MASTER_ADDR and MASTER_PORT
    JAX_NUM_PROCESSES        ->  WORLD_SIZE
    JAX_PROCESS_ID           ->  RANK  (and LOCAL_RANK picks the GPU)

`torchrun` sets all of them.  Usage, once, before any collective:

    from physically_based_renderer_tpu_torch.parallel import distributed
    distributed.ensure_initialized()        # no-op in a single process
    mesh = distributed.global_mesh()        # 1-D mesh over every rank

A mesh is a `torch.distributed.device_mesh.DeviceMesh` whose dimensions
carry the reference's axis names (`tiles`, `spp`); collectives run on
`mesh.get_group(axis)`.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def is_multiprocess_env() -> bool:
    """True when the environment describes a multi-process launch."""
    return (os.environ.get("MASTER_ADDR") is not None
            or os.environ.get("WORLD_SIZE", "1") not in ("", "1"))


def device_type() -> str:
    """The device type of the initialized group's ranks: "cuda" under
    NCCL, else "cpu"."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def rank_device() -> torch.device:
    """This rank's device: its GPU under NCCL, else the CPU."""
    if device_type() == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def ensure_initialized(coordinator_address: str | None = None,
                       num_processes: int | None = None,
                       process_id: int | None = None,
                       backend: str | None = None,
                       timeout: datetime.timedelta | None = None) -> bool:
    """Initialize the default process group once when running
    multi-process; True iff it is (now) initialized.

    A single process without the variables above does nothing: an
    initialization would wait for peers that never come.
    `coordinator_address` is "host:port" (TCP) or a URL
    (`tcp://...`, `file://...`); without it the variables are read
    (`env://`).  `backend` defaults to NCCL where CUDA is available, else
    gloo; under NCCL the rank's GPU (`LOCAL_RANK`, else the rank modulo the
    GPUs of the host) becomes the current device before the group forms.
    """
    if dist.is_initialized():
        return True
    explicit = coordinator_address or num_processes or process_id is not None
    if not (explicit or is_multiprocess_env()):
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0")))
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=num_processes if num_processes is not None else -1,
        rank=process_id if process_id is not None else -1, **kw)
    return True


def global_mesh(axis_name: str = "tiles") -> DeviceMesh:
    """1-D mesh over every rank of the world."""
    return init_device_mesh(device_type(), (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def hosts_chips_mesh(tile_axis: str = "tiles",
                     spp_axis: str = "spp") -> DeviceMesh:
    """2-D (hosts, devices per host) mesh: image tiles across hosts, spp
    across each host's devices, so the per-sample all-reduce stays inside a
    host and only film assembly crosses hosts.  Devices per host:
    `LOCAL_WORLD_SIZE` (torchrun sets it), else the whole world."""
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if per_host < 1 or world % per_host:
        raise ValueError(f"LOCAL_WORLD_SIZE {per_host} does not divide the "
                         f"world size {world}")
    return init_device_mesh(device_type(), (world // per_host, per_host),
                            mesh_dim_names=(tile_axis, spp_axis))


def spawn_local(entry: str, argv: list[str], n: int, backend: str) -> int:
    """Run `main(argv)` of module `entry` on n local ranks, one process a
    rank (the GPU of its rank under NCCL), joined through a file in a
    temporary directory; the exit code of the first rank that fails, else
    0.  What the CLIs' `--tiles N` does when no launcher started them."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(_rank_main, args=(entry, list(argv), n, backend,
                                         f"file://{tmp}/rendezvous"),
                       nprocs=n, join=False)
        try:
            while not ctx.join():
                pass
        except mp.ProcessExitedException as e:
            return e.exit_code or 1
    return 0


def _rank_main(rank: int, entry: str, argv: list[str], n: int, backend: str,
               init_method: str) -> None:
    import importlib
    import sys

    os.environ["LOCAL_RANK"] = str(rank)
    if backend == "gloo":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    ensure_initialized(init_method, n, rank, backend)
    try:
        rc = importlib.import_module(entry).main(argv)
    finally:
        dist.destroy_process_group()
    if rc:
        sys.exit(rc)


def run_tiles(n: int, device: str, entry: str, argv: list[str]):
    """What a CLI's `--tiles n` does before it renders.  Under a launcher
    (torchrun sets the variables above) or inside an initialized group,
    this process is one rank: the world must have n ranks on `device`'s
    type; returns None and the caller goes on as its rank.  Run plainly,
    it starts n local ranks that each run `entry`'s main(argv)
    (`spawn_local`: gloo on the CPU, NCCL with one GPU a rank) and returns
    their exit code.  Exit code 2, with a message, where the world or the
    host does not fit: more ranks than the host's GPUs mirrors the
    reference's too-few-devices ValueError."""
    import sys

    kind = torch.device(device).type
    backend = "nccl" if kind == "cuda" else "gloo"
    if ensure_initialized(backend=backend):
        world = dist.get_world_size()
        if world != n or device_type() != kind:
            print(f"error: --tiles {n} on {kind} in a world of {world} "
                  f"{device_type()} ranks", file=sys.stderr)
            return 2
        return None
    if kind == "cuda" and n > torch.cuda.device_count():
        print(f"error: --tiles {n} needs {n} GPUs, one a rank; this host "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    return spawn_local(entry, argv, n, backend)
