"""Package-level properties of the torch port: it stands alone, defaults
to the GPU without falling back to the CPU, and keeps the kernel wrapper's
CPU path on the plain version."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu_torch.nn.initializers import init_param
from gnntf_tpu_torch.ops import (BlockedSpMM, block_coo, blocked_spmm,
                                 ell_gather)
from gnntf_tpu_torch.ops.spmm import build_ell

PKG = Path(tt.__file__).resolve().parent


def test_import_pulls_in_no_jax():
    code = ("import sys; before = set(sys.modules); import gnntf_tpu_torch; "
            "added = set(sys.modules) - before; "
            "print(sorted(m for m in added if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'gnntf_tpu')))")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         cwd=str(PKG.parent), env=env)
    assert out.stdout.strip() == "[]", out.stdout


# the test files that run where JAX is not installed: the card tests and
# the bodies of spawned ranks
JAX_FREE_TESTS = sorted(
    p.stem for p in (PKG.parent / "tests").glob("test_torch_*.py")
    if p.stem.endswith(("_cuda", "_ranks")))


@pytest.mark.parametrize("name", JAX_FREE_TESTS)
def test_jax_free_test_files_import_no_jax(name):
    code = ("import sys; before = set(sys.modules); import " + name + "; "
            "added = set(sys.modules) - before; "
            "print(sorted(m for m in added if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'gnntf_tpu')))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(PKG.parent), str(PKG.parent / "tests")]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         cwd=str(PKG.parent), env=env)
    assert out.stdout.strip() == "[]", out.stdout


def test_no_source_mentions_the_jax_package():
    pattern = re.compile(r"(^\s*(import|from)\s+(jax|jaxlib|optax)\b)"
                         r"|(\bgnntf_tpu\.)", re.M)
    files = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    files.append(PKG.parent / "chip_smoke.py")
    assert len(files) > 1
    hits = [str(p) for p in files if pattern.search(p.read_text())]
    assert not hits


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tt.from_edges([0, 1], [1, 2])
    g = tt.from_edges([0, 1], [1, 2], device="cpu")
    with pytest.raises(RuntimeError):
        tt.APPNP(g, np.zeros((3, 4), np.float32), num_classes=2)
    with pytest.raises(RuntimeError):
        g.to("cuda")


def test_tf32_is_off():
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_cpu_wrapper_uses_plain_and_counts_nothing():
    rng = np.random.RandomState(0)
    layout = build_ell(rng.randint(0, 50, 400), rng.randint(0, 50, 400), 50)
    vals = torch.from_numpy(rng.randn(layout.n_vrows, layout.k)
                            .astype(np.float32))
    x = torch.from_numpy(rng.randn(50, 12).astype(np.float32))
    args = (torch.from_numpy(layout.idx), vals, x,
            torch.from_numpy(layout.vrow_row), 50)
    before = ell_gather.launches
    out = ell_gather(*args)
    assert ell_gather.launches == before
    assert torch.equal(out, tt.ops.ell_gather_plain(*args))


def test_cpu_blocked_wrapper_uses_plain_and_counts_nothing():
    rng = np.random.RandomState(0)
    layout = block_coo(rng.randint(0, 50, 400), rng.randint(0, 50, 400), 50,
                       window=16, tile=16, block_edges=32)
    prep = BlockedSpMM(layout, "cpu")
    val = torch.from_numpy(rng.randn(400).astype(np.float32))
    x = torch.from_numpy(rng.randn(50, 12).astype(np.float32))
    for lst in (prep.forward, prep.transposed):
        before = blocked_spmm.launches
        out = blocked_spmm(lst, val, x)
        assert blocked_spmm.launches == before
        assert torch.equal(out, tt.ops.blocked_spmm_plain(lst, val, x))


def test_header_change_rebuilds_every_library_that_includes_it(
        tmp_path, monkeypatch):
    """A library is stale when it is older than its source or a ``csrc/``
    header the source includes, directly or through another header (file
    mtimes only; nothing is compiled)."""
    from gnntf_tpu_torch.utils import kernels
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD", build)
    (csrc / "walk.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (csrc / "inner.cuh").write_text("#pragma once\n")
    (csrc / "a.cu").write_text('#include <stdint.h>\n#include "walk.cuh"\n')
    (csrc / "b.cu").write_text("#include <cuda_runtime.h>\n")
    for name in ("a", "b"):
        kernels.library_path(name).write_bytes(b"")

    def stamp(path, t):
        os.utime(path, (t, t))

    for path in csrc.iterdir():
        stamp(path, 1000)
    for name in ("a", "b"):
        stamp(kernels.library_path(name), 2000)
    assert sorted(p.name for p in kernels.inputs("a")) == [
        "a.cu", "inner.cuh", "walk.cuh"]
    assert not kernels._stale("a") and not kernels._stale("b")
    stamp(csrc / "inner.cuh", 3000)
    assert kernels._stale("a") and not kernels._stale("b")
    stamp(kernels.library_path("a"), 4000)
    assert not kernels._stale("a")
    stamp(csrc / "b.cu", 5000)
    assert kernels._stale("b") and not kernels._stale("a")
    kernels.library_path("a").unlink()
    assert kernels._stale("a")


@pytest.mark.parametrize("scheme", [0.3, "zero", "eye", "ones", "xavier",
                                    "he", "bernouli", "small"])
def test_init_schemes(scheme):
    g = torch.Generator().manual_seed(0)
    w = init_param(g, (6, 4), scheme)
    assert w.shape == (6, 4) and w.dtype == torch.float32
    bound = {0.3: 0.3, "xavier": (6 / 10) ** 0.5, "he": 1.0,
             "small": 0.5, "bernouli": 0.5}
    if scheme in bound:
        assert w.abs().max() <= bound[scheme]
        assert torch.equal(w, init_param(torch.Generator().manual_seed(0),
                                         (6, 4), scheme))
    if scheme == "bernouli":
        assert set(w.abs().unique().tolist()) == {0.5}
    if scheme in ("zero", "eye", "ones"):
        ref = {"zero": np.zeros, "ones": np.ones,
               "eye": lambda s: np.eye(*s)}[scheme]((6, 4))
        np.testing.assert_array_equal(w.numpy(), ref)


def test_init_rejects_unknown_scheme():
    with pytest.raises(ValueError):
        init_param(torch.Generator(), (2, 2), "bogus")


def test_measures_match_jax():
    pred = np.array([0, 1, 2, 2, 1])
    lab = np.array([0, 1, 1, 2, 0])
    assert tt.acc(pred, lab) == gt.acc(pred, lab)
    gt.set_seed(11)
    a = [gt.measures.next_seed() for _ in range(3)]
    tt.set_seed(11)
    assert [tt.next_seed() for _ in range(3)] == a
