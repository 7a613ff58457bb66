"""Column shards of the hidden weights over the ``feat`` axis under
``fit(mesh=, spmm=None | "gspmd")``, as the JAX package's GSPMD places
them (``gnntf_tpu/parallel/dist.py::param_shardings``, ``place_state``).

One gloo spawn at world size 4 (bodies in the JAX-free
``tests/test_torch_feat_shards_ranks.py``) runs every case:

* on ``make_mesh(2, 2)`` and ``make_mesh(1, 4)`` each rank holds, during
  ``fit``, the blocks ``param_shardings`` gives, and its moments alike;
* APPNP (host loop and fused) and a small GCNII, dropout on, equal the
  same mesh with every parameter replicated bit for bit, and one device
  within ``rtol=1e-5``; APPNP's layers without dropout from JAX's initial
  parameters match JAX's ``fit(mesh=make_mesh(2, 2))`` at ``TRAJ_TOL``;
* a checkpoint written on the sharded mesh holds whole arrays and resumes
  on one device;
* halo and ring keep every parameter whole, as in JAX;
* after ``fit`` the model holds whole parameters again.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnntf_tpu as gt
from gnntf_tpu import parallel as jp
from gnntf_tpu_torch.parallel import param_shardings
from gnntf_tpu_torch.utils.checkpoint import restore_checkpoint

import test_torch_parallel_ranks as R
import test_torch_feat_shards_ranks as S

TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)


def _jax_init(run):
    m = R.stack(gt, gt.Graph(jnp.asarray(run["row"]), jnp.asarray(run["col"]),
                             jnp.asarray(run["val"]), run["n"],
                             sorted_by_row=True), run["features"], 3)
    return m, {k: np.asarray(v) for k, v in m.init(0).items()}


def _cases(ckpt):
    jax_run = dict(S.appnp((2, 2)), model="stack")
    _, init = _jax_init(jax_run)
    jax_run["fit"] = dict(jax_run["fit"], init_params=init, epochs=6)
    cases = {
        "appnp": S.appnp((2, 2)),
        "appnp_fused": S.appnp((2, 2), block_epochs=3),
        "gcnii": S.gcnii((2, 2)),
        "appnp_1x4": S.appnp((1, 4)),
        "jax": jax_run,
        "checkpoint": dict(S.appnp((2, 2), checkpoint_every=2),
                           checkpoint=ckpt),
        "halo": S.appnp((2, 2), spmm="halo"),
        "ring": S.appnp((2, 2), spmm="ring"),
    }
    for name in ("appnp", "appnp_fused", "gcnii"):
        cases[name + "_replicated"] = dict(cases[name], replicated=True)
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = _cases(str(tmp_path_factory.mktemp("ckpt")))
    names = list(cases)
    per_rank = R.spawn(4, S.shards_body, [cases[k] for k in names])
    return cases, [dict(zip(names, r)) for r in per_rank]


def _blocks(run):
    """The shape of each parameter's block on one rank of the run's mesh,
    from ``param_shardings``."""
    model = R.build_model(run)
    n_edge, n_feat = run["mesh"]
    mesh = types.SimpleNamespace(shape={"edge": n_edge, "feat": n_feat})
    out = {}
    for spec in model.param_specs:
        rows, *cols = spec.shape
        sharded = param_shardings(model, mesh)[spec.name] == ("feat",)
        out[spec.name] = (rows, cols[0] // n_feat) if sharded \
            else spec.shape
    return out


@pytest.mark.parametrize("name", ["appnp", "appnp_1x4", "gcnii"])
def test_ranks_hold_their_blocks(ranks, name):
    cases, per_rank = ranks
    want = _blocks(cases[name])
    assert any(want[k] != s for k, s in per_rank[0][name]["whole"].items())
    for r in per_rank:
        assert r[name]["held"] == want
        assert r[name]["moments"] == want
        assert r[name]["unsharded"]
        assert {k: tuple(p.shape) for k, p in r[name]["params"].items()} \
            == r[name]["whole"]


@pytest.mark.parametrize("name", ["appnp", "appnp_fused", "gcnii"])
def test_sharded_fit_equals_replicated(ranks, name):
    """The same mesh with every parameter whole: equal bit for bit, and
    every rank's parameters equal."""
    _, per_rank = ranks
    for r in per_rank:
        a, b = r[name], r[name + "_replicated"]
        assert a["hist"] == b["hist"]
        assert b["held"] == b["whole"]
        for k, p in a["params"].items():
            assert torch.equal(p, b["params"][k]), k
            assert torch.equal(p, per_rank[0][name]["params"][k]), k


def _single(run):
    model = R.build_model(run)
    fit = {k: v for k, v in run["fit"].items() if k != "spmm"}
    return model.train(*R.tasks(run), seed=0, **fit), model


@pytest.mark.parametrize("name", ["appnp", "appnp_fused", "gcnii",
                                  "appnp_1x4"])
def test_sharded_fit_matches_one_device(ranks, name):
    cases, per_rank = ranks
    hist, _ = _single(cases[name])
    got = per_rank[0][name]["hist"]
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(got[key], hist[key], rtol=1e-5)
    assert got["best_epoch"] == hist["best_epoch"]


def test_sharded_fit_matches_jax_mesh_fit(ranks):
    cases, per_rank = ranks
    run = cases["jax"]
    jm, init = _jax_init(run)
    mesh = jp.make_mesh(2, 2, devices=jax.devices()[:4])
    want = jm.train(gt.NodeClassification(run["train"],
                                          run["labels"][run["train"]]),
                    gt.NodeClassification(run["valid"],
                                          run["labels"][run["valid"]]),
                    patience=100, epochs=6, seed=0, init_params=dict(init),
                    mesh=mesh)
    got = per_rank[0]["jax"]
    assert got["held"] != got["whole"]
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(got["hist"][key], want[key], **TRAJ_TOL)
    assert got["hist"]["best_epoch"] == want["best_epoch"]
    for k, v in jm.params.items():
        np.testing.assert_allclose(got["params"][k].numpy(), np.asarray(v),
                                   **TRAJ_TOL)


def test_checkpoint_of_a_sharded_mesh_resumes_on_one_device(ranks, tmp_path):
    """The checkpoint holds whole arrays (parameters, best parameters,
    moments); one device resumes from it and runs on to the end."""
    import shutil
    cases, per_rank = ranks
    run = cases["checkpoint"]
    directory = str(tmp_path / "rank0")
    shutil.copytree(f"{run['checkpoint']}/rank0", directory)
    step, state = restore_checkpoint(directory)
    whole = per_rank[0]["checkpoint"]["whole"]
    assert step == run["fit"]["epochs"] - 1
    for group in ("params", "best_params"):
        assert {k: v.shape for k, v in state[group].items()} == whole
    for part in ("m", "v"):
        assert {k: v.shape for k, v in state["opt_state"][part].items()} \
            == whole
    for k, p in per_rank[0]["checkpoint"]["params"].items():
        np.testing.assert_array_equal(state["best_params"][k], p.numpy())
    model = R.build_model(run)
    fit = dict(run["fit"], epochs=run["fit"]["epochs"] + 2)
    hist = model.train(*R.tasks(run), seed=0, checkpoint_dir=directory,
                       resume=True, **fit)
    assert len(hist["train_loss"]) == 2
    assert np.isfinite(hist["train_loss"]).all()


@pytest.mark.parametrize("name", ["halo", "ring"])
def test_halo_and_ring_keep_whole_parameters(ranks, name):
    cases, per_rank = ranks
    for r in per_rank:
        assert r[name]["held"] == r[name]["whole"]
        assert r[name]["moments"] == r[name]["whole"]
    hist, _ = _single(cases[name])
    np.testing.assert_allclose(per_rank[0][name]["hist"]["train_loss"],
                               hist["train_loss"], rtol=1e-5)
