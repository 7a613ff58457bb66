"""Ranks that end their program normally, with the port's process groups
still referenced, exit cleanly (``parallel/multihost.py::
shutdown_distributed``, registered at exit by ``launch_distributed``).

Each case starts two gloo ranks as plain ``subprocess`` programs, not through
a spawn helper, so nothing but the port stands between a rank's last
collective and its interpreter's finalization.  A rank launches, builds the
meshes the two-process tests build (``make_pod_mesh``, its hierarchical
form, ``make_mesh``, so their axis groups and the flattened group exist),
runs all-reduces, one of them in an autograd backward, keeps the meshes
and an autograd graph whose context holds a group in module globals, leaves
async collectives in flight, and returns from ``__main__``.  A handler
registered with ``atexit`` before the launch runs after the shutdown and
reports this process's OS threads against their count before the launch.
This file imports no JAX.
"""
import json
import os
import subprocess
import sys

import pytest

from gnntf_tpu_torch.parallel.multihost import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RANK = r'''
import atexit, json, sys
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, port, mode = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from gnntf_tpu_torch.parallel import (launch_distributed, make_mesh,
                                      make_pod_mesh, shutdown_distributed)
from gnntf_tpu_torch.parallel.collectives import (all_gather, all_reduce,
                                                  exchange)
from gnntf_tpu_torch.parallel.multihost import os_threads

before = len(os_threads())


def report():  # registered first, so it runs after the shutdown
    print("THREADS " + json.dumps({"before": before,
                                   "after": len(os_threads()),
                                   "initialized": dist.is_initialized()}),
          flush=True)


atexit.register(report)
launch_distributed(f"localhost:{port}", num_processes=2, process_id=rank,
                   device="cpu")
pod = make_pod_mesh(1)
hier = make_pod_mesh(1, hierarchical=True)
flat = make_mesh()
x = torch.arange(4.0, requires_grad=True)
y = all_reduce(x * (rank + 1), pod.group("edge"))
y.sum().backward()
assert x.grad.tolist() == [rank + 1.0] * 4
assert y.tolist() == [0.0, 3.0, 6.0, 9.0]
# an autograd graph whose context holds a group, kept to the end
kept = all_gather(x[None] * 2, flat.group("edge"))


def in_flight():
    """Async collectives started and never waited on (the works are
    dropped on return, the collectives still queued)."""
    exchange(torch.empty(2, 3), torch.full((2, 3), float(rank)),
             hier.group(("edge_host", "edge")), async_op=True)
    dist.all_reduce(torch.ones(5), group=flat.group("feat"), async_op=True)


in_flight()
if mode == "explicit":
    print("SHUTDOWN " + json.dumps([shutdown_distributed(),
                                    shutdown_distributed()]), flush=True)
if mode == "raise" and rank == 1:
    raise RuntimeError("rank 1 fails after its collectives")
'''


def _run(tmp_path, mode, tries=3):
    """Both ranks' (returncode, stdout, stderr), rerun on a fresh port only
    when rank 0 could not bind the store."""
    prog = tmp_path / "rank.py"
    prog.write_text(RANK)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for attempt in range(tries):
        port = free_port()
        procs = [subprocess.Popen([sys.executable, str(prog), str(r),
                                   str(port), mode], cwd=str(tmp_path),
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        try:
            outs = [p.communicate(timeout=180) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        runs = [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]
        if "EADDRINUSE" not in runs[0][2] or attempt + 1 == tries:
            return runs


def _threads(out):
    line = [l for l in out.splitlines() if l.startswith("THREADS ")]
    assert len(line) == 1, out
    return json.loads(line[0][len("THREADS "):])


@pytest.mark.parametrize("mode", ["exit", "explicit"])
def test_ranks_exit_cleanly_with_groups_referenced(tmp_path, mode):
    """Every rank exits 0 without ``terminate called``; at exit no group is
    initialized and the OS threads are back to their count before the
    launch (the groups' worker threads joined while Python was live).
    ``explicit`` calls ``shutdown_distributed`` itself: it succeeds, and a
    second call does nothing."""
    for rank, (code, out, err) in enumerate(_run(tmp_path, mode)):
        assert code == 0, (rank, out, err)
        assert "terminate called" not in err, (rank, err)
        threads = _threads(out)
        assert not threads["initialized"], (rank, out)
        assert threads["after"] == threads["before"], (rank, out, err)
        if mode == "explicit":
            assert "SHUTDOWN [true, true]" in out, (rank, out)


def test_failing_rank_exits_without_waiting(tmp_path):
    """A rank that ends in an exception skips the barrier and exits 1; the
    other, whose barrier then fails, still frees its groups and exits 0;
    neither hangs nor aborts."""
    (code0, out0, err0), (code1, out1, err1) = _run(tmp_path, "raise")
    assert code1 == 1 and "rank 1 fails" in err1, (out1, err1)
    assert code0 == 0, (out0, err0)
    for out, err in ((out0, err0), (out1, err1)):
        assert "terminate called" not in err, err
        threads = _threads(out)
        assert threads["after"] == threads["before"], (out, err)
