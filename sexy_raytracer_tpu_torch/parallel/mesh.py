"""Process groups and the ("rays", "samples") mesh for distributed
rendering and training (counterpart of ``sexy_raytracer_tpu/parallel/mesh.py``).

One process per device: a rank owns one device, and the mesh is a 2-D
``DeviceMesh`` over all ranks, named ``("rays", "samples")``:

  * pixels are sharded over ``"rays"``: each ray shard traces a contiguous
    slice of a chunk's pixel ids;
  * sample batches can be sharded over ``"samples"``: each sample shard
    traces its own sample ids and the partial radiance sums are added with
    an all-reduce;
  * the scene is replicated: every rank holds it whole on its device;
  * inverse rendering averages the gradients over the whole mesh
    (``diff/inverse.make_train_step``).

The collectives are NCCL's on the card and gloo's on the CPU. The ranks are
started by ``torchrun`` (its environment variables), by a caller that
passes the coordinator's address, or by ``spawn`` below.
"""

from __future__ import annotations

import datetime
import os
import socket
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

RAY_AXIS = "rays"
SAMPLE_AXIS = "samples"

# a rank that dies fails the others' next collective after this long,
# not after the default 30 minutes
GROUP_TIMEOUT = datetime.timedelta(seconds=120)
_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None,
                     device=None) -> None:
    """Join the process group (no-op if nothing is configured or a group is
    already up).

    ``coordinator`` is ``host:port`` of rank 0's store, with
    ``num_processes`` and ``process_id``; without it the torchrun variables
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) are read.
    ``device`` is this rank's device, the card by default (``cuda`` with
    ``LOCAL_RANK``'s index, else the rank's modulo the card count); it picks
    the backend, ``nccl`` for a card and ``gloo`` for the CPU, unless
    ``backend`` names one.
    """
    if dist.is_initialized():
        return
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        init_method = f"tcp://{coordinator}"
        world, rank = int(num_processes), int(process_id)
    elif all(k in os.environ for k in _TORCHRUN_VARS):
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if dev.index is None:
            local = os.environ.get("LOCAL_RANK")
            dev = torch.device("cuda", int(local) if local is not None
                               else rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=GROUP_TIMEOUT)


def make_mesh(n_rays: int | None = None, n_samples: int = 1,
              device_type: str = "cuda"):
    """The ("rays", "samples") mesh over every rank of the process group.

    Default: all ranks on the ray axis. Rank ``r`` sits at ray shard
    ``r // n_samples`` and sample shard ``r % n_samples``, as the JAX
    package reshapes its device list. ``device_type`` is the ranks'
    device type: the card unless the caller asks for ``"cpu"``.
    """
    world = dist.get_world_size()
    if n_rays is None:
        n_rays = world // n_samples
    if n_rays * n_samples != world:
        raise ValueError(f"a {n_rays} x {n_samples} mesh needs "
                         f"{n_rays * n_samples} ranks, the group has {world}")
    return init_device_mesh(device_type, (n_rays, n_samples),
                            mesh_dim_names=(RAY_AXIS, SAMPLE_AXIS))


def axis_size(mesh, axis: str) -> int:
    """The number of shards along ``axis``."""
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def mesh_device(mesh) -> torch.device:
    """This rank's device."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def replicate_scene(scene, mesh):
    """The scene, whole, on this rank's device."""
    return scene.to(mesh_device(mesh))


def shard_rays(array, mesh):
    """This rank's contiguous slice of the leading (pixel) axis, on its
    device: ray shard ``i`` of ``n`` takes rows ``i * N / n`` to ``(i + 1)
    * N / n``. ``array`` is the global array (numpy or a tensor), the same
    on every rank; JAX's multi-process path is handed each process's slice
    instead.
    """
    t = torch.as_tensor(array)
    n = axis_size(mesh, RAY_AXIS)
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows do not split into {n} ray "
                         "shards")
    k = t.shape[0] // n
    i = mesh.get_local_rank(RAY_AXIS)
    return t[i * k:(i + 1) * k].to(mesh_device(mesh))


def free_port() -> int:
    """A localhost port that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world_size, port, backend, device, args, out_dir):
    """A spawned rank: its device, the group, ``fn(*args)``, its result."""
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    elif dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    init_distributed(f"127.0.0.1:{port}", world_size, rank, backend, dev)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
    except BaseException:
        # written before this rank leaves the group, so before any rank it
        # fails in a collective writes its own
        tmp_path = os.path.join(out_dir, f"{rank}.err.tmp")
        with open(tmp_path, "w") as f:
            f.write(f"{time.monotonic_ns()}\n{traceback.format_exc()}")
        os.replace(tmp_path, os.path.join(out_dir, f"{rank}.err"))
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, backend: str | None, device, *args,
          timeout: float = 900.0) -> list:
    """Run ``fn(*args)`` on ``world_size`` new processes that form a group
    over a free localhost port -> the list of their return values by rank.

    The caller names the ranks' ``device`` (``"cuda"`` or ``"cpu"``) and
    ``backend`` (None: ``nccl`` on the card, ``gloo`` on the CPU).
    ``fn`` must be importable by name (the children start from a fresh
    interpreter). Ranks on the CPU run one torch thread each; ranks on the
    card take card ``rank % device_count`` (so two ranks may share one card
    over gloo; NCCL refuses that). A rank that raises or exits nonzero
    fails the call, and the others are stopped; so are all of them past
    ``timeout`` seconds. The error raised names the rank that raised first
    with its traceback (a rank that waited for it in a collective fails
    after it). A port taken between its probe and its bind is retried once
    on another.
    """
    import torch.multiprocessing as tmp

    run = (fn, world_size, backend, str(device), args, timeout)
    try:
        return _spawn_once(*run)
    except tmp.ProcessRaisedException as e:
        if "address already in use" not in str(e).lower():
            raise
    return _spawn_once(*run)


def _spawn_once(fn, world_size, backend, device, args, timeout):
    import torch.multiprocessing as tmp

    with tempfile.TemporaryDirectory() as out_dir:
        ctx = tmp.start_processes(
            _rank_main, nprocs=world_size, join=False, start_method="spawn",
            args=(fn, world_size, free_port(), backend, device, args,
                  out_dir))
        try:
            waited = 0.0
            while not ctx.join(timeout=5.0):
                waited += 5.0
                if waited >= timeout:
                    raise TimeoutError(f"{world_size} ranks of {fn.__name__} "
                                       f"ran past {timeout:.0f} s")
        except tmp.ProcessRaisedException as e:
            first = _first_rank_error(out_dir)
            if first is None:
                raise
            rank, text = first
            raise RuntimeError(f"rank {rank} of {world_size} raised first "
                               f"in {fn.__name__}:\n{text}") from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
        return [torch.load(os.path.join(out_dir, f"{r}.pt"),
                           weights_only=False)
                for r in range(world_size)]


def _first_rank_error(out_dir):
    """(rank, traceback) of the rank whose error was written first (each
    file starts with the monotonic clock's ns, which all processes share),
    or None if no rank wrote one."""
    errors = []
    for name in os.listdir(out_dir):
        if name.endswith(".err"):
            with open(os.path.join(out_dir, name)) as f:
                stamp, text = f.read().split("\n", 1)
            errors.append((int(stamp), int(name.split(".")[0]), text))
    if not errors:
        return None
    _, rank, text = min(errors)
    return rank, text
