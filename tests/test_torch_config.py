"""The port's ``config.py`` against the JAX package's: the same fields,
defaults, flags and JSON, and each configuration's ``build`` makes the
port's model with the JAX model's parameter names and shapes."""
import argparse
import dataclasses

import numpy as np
import pytest

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu import config as jc
from gnntf_tpu_torch import config as pc

CLASSES = sorted(jc.MODEL_CONFIGS)


def _data():
    rng = np.random.RandomState(0)
    n = 60
    src, dst = rng.randint(0, n, 200), rng.randint(0, n, 200)
    return src, dst, n, rng.randn(n, 12).astype(np.float32)


def test_same_configurations():
    assert sorted(pc.MODEL_CONFIGS) == CLASSES
    for key in CLASSES + ["train"]:
        jcls = jc.TrainConfig if key == "train" else jc.MODEL_CONFIGS[key]
        pcls = pc.TrainConfig if key == "train" else pc.MODEL_CONFIGS[key]
        assert jcls.__name__ == pcls.__name__
        assert [(f.name, str(f.type), f.default)
                for f in dataclasses.fields(jcls)] == [
                    (f.name, str(f.type), f.default)
                    for f in dataclasses.fields(pcls)]
        assert pc.to_json(pcls()) == jc.to_json(jcls())
    assert pc.TrainConfig().kwargs() == jc.TrainConfig().kwargs()


@pytest.mark.parametrize("key", CLASSES + ["train"])
@pytest.mark.parametrize("argv", [[], ["--latent-dims", "32,16",
                                       "--dropout", "0.25"]])
def test_flags_round_trip_like_jax(key, argv):
    jcls = jc.TrainConfig if key == "train" else jc.MODEL_CONFIGS[key]
    pcls = pc.TrainConfig if key == "train" else pc.MODEL_CONFIGS[key]
    if key == "train" and argv:
        argv = ["--epochs", "7", "--learning-rate", "0.05", "--resume",
                "yes"]
    jp, pp = argparse.ArgumentParser(), argparse.ArgumentParser()
    jc.add_flags(jp, jcls)
    pc.add_flags(pp, pcls)
    jcfg = jc.from_flags(jcls, jp.parse_args(argv))
    pcfg = pc.from_flags(pcls, pp.parse_args(argv))
    assert pc.to_json(pcfg) == jc.to_json(jcfg)
    assert pcfg == pcls(**dataclasses.asdict(pcfg))


@pytest.mark.parametrize("key", CLASSES)
def test_build_makes_the_ports_model_with_jax_parameter_shapes(key):
    src, dst, n, features = _data()
    jcfg, pcfg = jc.MODEL_CONFIGS[key](), pc.MODEL_CONFIGS[key]()
    if key == "gcnii":
        jcfg.iterations = pcfg.iterations = 4
    jm = jcfg.build(gt.from_edges(src, dst, n_nodes=n, directed=False),
                    features, num_classes=5)
    pm = pcfg.build(tt.from_edges(src, dst, n_nodes=n, directed=False,
                                  device="cpu"), features, num_classes=5,
                    device="cpu")
    assert type(pm).__name__ == type(jm).__name__
    assert isinstance(pm, tt.GNN) and pm.device.type == "cpu"
    assert [(s.name, s.shape) for s in pm.param_specs] == [
        (s.name, s.shape) for s in jm.param_specs]
    out = pm.forward(pm.features)
    assert out.shape == (n, 5) and bool(out.isfinite().all())


def test_build_defaults_to_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src, dst, n, features = _data()
    graph = tt.from_edges(src, dst, n_nodes=n, directed=False, device="cpu")
    with pytest.raises(RuntimeError):
        pc.GATConfig().build(graph, features, num_classes=5)
