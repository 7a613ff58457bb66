"""Multi-process scale-out entry points (the JAX package's
``parallel/multihost.py``, on ``torch.distributed``).

:func:`launch_distributed` initializes the process group: over NCCL on the
cards (each process on its own card), over gloo where the caller asks for
the CPU; from explicit arguments, or from the variables ``torchrun`` sets
(the counterpart of the JAX runtime's pod auto-detection).
:func:`make_pod_mesh` then lays the ranks out host-major, edge index =
``host * chips_per_host + chip``, so contiguous edge shards are host-local;
``hierarchical=True`` gives the ``(edge_host, edge, feat)`` mesh of
``hier_halo``'s three-phase exchange.

:func:`shutdown_distributed` frees every process group of the process
while the interpreter is live; ``launch_distributed`` registers it with
``atexit`` when it initializes a group.  A gloo or NCCL group that is freed
only when the interpreter finalizes can abort the process after its work is
done: a worker thread still dropping the last collective's work asks for
the GIL, which a finalizing interpreter answers with ``pthread_exit``, and
that unwind through a ``noexcept`` destructor calls ``std::terminate``.

:func:`shard_graph_local` gives a rank the edge shard it holds alone: no
process ever holds, gathers or allocates the whole edge list.  The gspmd
executor (``dist.GspmdExecutor``) takes such a shard directly; the halo and
ring plans need the whole structure and refuse it, as the JAX package's
do.
"""
from __future__ import annotations

import atexit
import gc
import os
import socket
import sys
import warnings
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from ..graph.coo import Graph
from ..utils.device import resolve_device
from .collectives import IN_FLIGHT, rank_of
from .dist import EDGE_AXIS, FEAT_AXIS, Mesh

EDGE_HOST_AXIS = "edge_host"  # hierarchical meshes: the hosts' part of edge

_TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
DeviceIds = Union[None, int, Sequence[int]]


def free_port() -> int:
    """An OS-assigned free TCP port on this host (for the address of a
    single-node process group)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# the names (as /proc lists them, cut to 15 characters) of the threads that
# the process groups and their store run: gloo's, NCCL's, the TCP store's
_BACKEND_THREADS = ("gloo", "nccl", "tcpstore")


def os_threads() -> Optional[list]:
    """The names of this process's OS threads (``/proc/self/task``), None
    where the OS does not list them."""
    try:
        tasks = os.listdir("/proc/self/task")
    except OSError:
        return None
    names = []
    for t in tasks:
        try:
            with open(f"/proc/self/task/{t}/comm") as f:
                names.append(f.read().strip())
        except OSError:  # the thread ended meanwhile
            pass
    return names


def _backend_threads(names) -> int:
    return sum(any(b in n for b in _BACKEND_THREADS) for n in names)


class _Launch:
    """What :func:`launch_distributed` recorded for the shutdown: the
    backend threads before it initialized the group, whether the shutdown
    is registered with ``atexit``, and whether it ran since."""
    threads: Optional[int] = None
    registered = False
    done = True


def launch_distributed(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None,
                       local_device_ids: DeviceIds = None, *,
                       device="cuda") -> bool:
    """Initialize the process group (idempotent: nothing happens when it is
    initialized already).

    With a coordinator ``host:port``, or ``num_processes`` not in (None, 1),
    it runs ``init_process_group`` over ``tcp://`` with ``num_processes``
    ranks, this one ``process_id`` (each taken from ``WORLD_SIZE`` and
    ``RANK`` where not given).  With nothing passed it initializes from
    ``torchrun``'s variables (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``) when they are set, and otherwise does
    nothing.  The backend is NCCL, after ``torch.cuda.set_device`` to the
    first of ``local_device_ids`` (else ``LOCAL_RANK``, else 0); gloo when
    ``device`` is the CPU.  When it initializes the group it registers
    :func:`shutdown_distributed` with ``atexit`` (once a process).  Returns
    True when more than one process runs."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and num_processes in (None, 1):
        if not all(k in env for k in _TORCHRUN):
            return False
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if coordinator_address is None:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         "address host:port")
    device = resolve_device(device)
    backend = "gloo"
    if device.type == "cuda":
        if local_device_ids is None:
            local = int(env.get("LOCAL_RANK", 0))
        elif isinstance(local_device_ids, int):
            local = local_device_ids
        else:
            local = int(list(local_device_ids)[0])
        torch.cuda.set_device(local)
        backend = "nccl"
    names = os_threads()
    _Launch.threads = None if names is None else _backend_threads(names)
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _Launch.done = False
    if not _Launch.registered:
        atexit.register(_shutdown_at_exit)
        _Launch.registered = True
    return dist.get_world_size() > 1


def shutdown_distributed(barrier: bool = True) -> bool:
    """Free every process group of this process, and its worker threads,
    while the interpreter is live.  ``launch_distributed`` registers it with
    ``atexit``; a program may call it sooner, also for a group it
    initialized itself.  A second call does nothing.

    In order: a barrier over every rank (where more than one runs and
    ``barrier`` is set; the shutdown at exit skips it when the program ends
    in an exception, so a failed rank does not wait for the others: their
    next collective then fails); a wait on the port's async exchanges still
    held (``collectives.IN_FLIGHT``); ``destroy_process_group()``, which
    drops ``torch.distributed``'s references to every group, the default
    one, the meshes' axis groups and ``Mesh``'s flattened ones; then a
    ``gc.collect()``, which frees a group that only a reference cycle still
    reached.  No object of the port holds a group strongly (meshes,
    executors and autograd contexts keep ``collectives.GroupRef``), so each
    group's destructor runs here and joins its worker threads.

    A barrier or a wait that fails (a peer failed or left) is reported as
    a warning, and the groups are freed all the same.  Returns True when
    this process's gloo, NCCL and store threads are as many as before
    ``launch_distributed`` initialized the group (or the OS does not list
    threads), False when some outlived the shutdown: an object outside the
    port still holds a group or its work."""
    if _Launch.done and not dist.is_initialized():
        return True
    _Launch.done = True
    if dist.is_initialized():
        try:
            if barrier and dist.get_world_size() > 1:
                dist.barrier()
            for work in list(IN_FLIGHT):
                work.wait()
        except Exception as e:
            warnings.warn(f"shutdown_distributed: {e}", RuntimeWarning)
        dist.destroy_process_group()
    gc.collect()
    names = os_threads()
    if names is None or _Launch.threads is None:
        return True
    return _backend_threads(names) <= _Launch.threads


def _shutdown_at_exit() -> None:
    failing = (getattr(sys, "last_exc", None) is not None
               or getattr(sys, "last_value", None) is not None)
    if not shutdown_distributed(barrier=not failing):
        print("shutdown_distributed: gloo, NCCL or store threads outlived "
              "the shutdown", file=sys.stderr)


def _hosts() -> int:
    """The number of hosts: ``WORLD_SIZE / LOCAL_WORLD_SIZE`` under
    ``torchrun``, else 1."""
    env = os.environ
    if "WORLD_SIZE" in env and "LOCAL_WORLD_SIZE" in env:
        return max(1, int(env["WORLD_SIZE"]) // int(env["LOCAL_WORLD_SIZE"]))
    return 1


def make_pod_mesh(n_feat: int = 1, *, n_edge_dcn: Optional[int] = None,
                  n_edge_ici: Optional[int] = None,
                  hierarchical: bool = False) -> Mesh:
    """An ``(edge, feat)`` mesh whose edge axis spans every host, laid out
    host-major (edge index = ``host * chips_per_host + chip``, the ranks of
    one host contiguous as ``torchrun`` numbers them), or with
    ``hierarchical`` the ``(edge_host, edge, feat)`` mesh, which also has
    the group over both edge axes in that order.  ``n_edge_dcn`` defaults
    to the number of hosts (``WORLD_SIZE / LOCAL_WORLD_SIZE`` under
    ``torchrun``, else 1); ``n_edge_ici`` to a host's ranks over
    ``n_feat``.  Raises ``ValueError`` where the sizes do not multiply to
    the world size, as the JAX package does."""
    if not dist.is_initialized():
        raise RuntimeError("make_pod_mesh needs an initialized process group "
                           "(launch_distributed)")
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if n_edge_dcn is None:
        n_edge_dcn = _hosts()
    if n_edge_ici is None:
        if (n // n_edge_dcn) % n_feat:
            raise ValueError(f"{n} devices / {n_edge_dcn} hosts not "
                             f"divisible by feat={n_feat}")
        n_edge_ici = n // n_edge_dcn // n_feat
    if n_edge_dcn * n_edge_ici * n_feat != n:
        raise ValueError(f"pod mesh {n_edge_dcn}x{n_edge_ici}x{n_feat} != "
                         f"{n} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if hierarchical:
        return Mesh(init_device_mesh(
            device_type, (n_edge_dcn, n_edge_ici, n_feat),
            mesh_dim_names=(EDGE_HOST_AXIS, EDGE_AXIS, FEAT_AXIS)),
            flatten=(EDGE_HOST_AXIS, EDGE_AXIS))
    return Mesh(init_device_mesh(device_type, (n_edge_dcn * n_edge_ici,
                                               n_feat),
                                 mesh_dim_names=(EDGE_AXIS, FEAT_AXIS)))


def shard_graph_local(local: Graph, mesh: Mesh, n_edges_global: int,
                      n_nodes: int) -> Graph:
    """This rank's edge shard of the padded global edge list, from the
    slice it holds alone: ``local`` is its contiguous slice (rank ``r`` of
    the ``edge`` axis holds edges ``r * E / P`` to ``(r + 1) * E / P - 1`` of
    the destination-sorted list, padded to a multiple of ``P``, E =
    ``n_edges_global``).  The shard keeps its own row, col and val (on the
    mesh's device) with ``global_edges`` and ``edge_offset``
    (``graph/coo.py``).  Raises ``ValueError`` when ``n_edges_global`` does
    not divide the edge axis or ``local`` is not a slice of that size."""
    n_edge = mesh.shape[EDGE_AXIS]
    if n_edges_global % n_edge:
        raise ValueError("global edge count must divide the edge axis "
                         "(pad with pad_graph first)")
    per = n_edges_global // n_edge
    if local.n_edges != per:
        raise ValueError(f"a rank's slice holds {per} of {n_edges_global} "
                         f"edges, got {local.n_edges}")
    device = mesh.device
    return Graph(row=local.row.to(device), col=local.col.to(device),
                 val=local.val.to(device), n_nodes=n_nodes,
                 num_self_loop=local.num_self_loop,
                 sorted_by_row=local.sorted_by_row,
                 edge_offset=rank_of(mesh.group(EDGE_AXIS)) * per,
                 global_edges=n_edges_global)
