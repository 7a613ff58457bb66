"""Generic NN layers (reference: gnntf/core/nn/layers.py).  Flow control
(``Branch``/``Resume``/``Concatenate``/``Tradeoff``) reads other layers'
outputs from the :class:`Forward` context, as the JAX package does."""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import torch

from .core import Forward, Layer, Network


def _identity(x):
    return x


class Dense(Layer):
    """W (in, out) 'small'-init + optional zero-init bias;
    ``activation(x @ W + b)`` then output dropout
    (reference layers.py:125-136).  ``outputs=None`` keeps the input width."""

    def build(self, net: Network, outputs: Optional[int] = None,
              activation: Callable = _identity, bias: bool = True,
              dropout: float = 0.0, regularize: bool = True):
        n, d = net.top_shape()
        if outputs is None:
            outputs = d
        self.W = net.create_param((d, outputs), regularize=regularize)
        self.b = net.create_param((1, outputs), "zero", regularize=regularize) \
            if bias else None
        self.activation = activation
        self.dropout_rate = dropout
        return (n, outputs)

    def apply(self, fw: Forward, x):
        y = torch.matmul(x, fw.param(self.W))
        if self.b is not None:
            y = y + fw.param(self.b)
        return fw.dropout(self.activation(y), self.dropout_rate)


class Dropout(Layer):
    """Mode-aware feature dropout (reference layers.py:175-181)."""

    def build(self, net: Network, rate: float = 0.5):
        self.rate = rate
        return net.top_shape()

    def apply(self, fw: Forward, x):
        return fw.dropout(x, self.rate)


class Activation(Layer):
    """String-dispatched activations, learnable ones included (reference
    layers.py:139-172):

      relu / linear / tanh / exp / softmax(axis=1)
      scale      — x * (1 + s), s a zero-init learnable scalar
      kernel     — log of the sum of 3 learnable exp-affine maps
      softthresh — soft threshold, fixed or learnable theta
    """

    def build(self, net: Network, activation: str = "relu", **kwargs):
        self.kind = activation
        if activation == "scale":
            self.s = net.create_param((1, 1), "zero", regularize=False)
        elif activation == "kernel":
            self.scales = [net.create_param((1, 1), "ones", regularize=False)]
            self.scales += [net.create_param((1, 1), "zero", regularize=False)
                            for _ in range(5)]
        elif activation == "softthresh":
            if "threshold" in kwargs:
                self.theta = float(kwargs["threshold"])
                self.theta_param = None
            else:
                self.theta = None
                self.theta_param = net.create_param((1, 1), "zero",
                                                    regularize=False)
        return net.top_shape()

    def apply(self, fw: Forward, x):
        k = self.kind
        if k == "relu":
            return torch.relu(x)
        if k == "linear":
            return x
        if k == "tanh":
            return torch.tanh(x)
        if k == "exp":
            return torch.exp(x)
        if k == "softmax":
            return torch.softmax(x, dim=1)
        if k == "scale":
            return x * (1.0 + fw.param(self.s))
        if k == "kernel":
            s1, s2, s3, s4, s5, s6 = (fw.param(p) for p in self.scales)
            return torch.log(torch.exp(x * s1 + s4) + torch.exp(x * s2 + s5)
                             + torch.exp(x * s3 + s6))
        if k == "softthresh":
            theta = self.theta if self.theta is not None \
                else fw.param(self.theta_param)
            return torch.relu(x - theta) - torch.relu(theta - x)
        raise ValueError(f"Unknown activation {k!r}")


class Branch(Layer):
    """Emits a constant tensor, ignoring the running features (reference
    layers.py:68-74): restarts the trunk from external data, put on the
    model's device (floating data as float32)."""

    def build(self, net: Network, features):
        features = torch.as_tensor(features, device=net.device)
        if features.is_floating_point():
            features = features.to(torch.float32)
        self.features = features
        return tuple(features.shape)

    def apply(self, fw: Forward, x):
        return self.features


class Resume(Layer):
    """Re-emits another layer's output of this forward (reference
    layers.py:77-83): restarts the trunk at an earlier point."""

    def build(self, net: Network, H0: Layer):
        self.H0 = H0
        return H0.output_shape

    def apply(self, fw: Forward, x):
        return fw.value_of(self.H0)


class Concatenate(Layer):
    """Feature-wise (axis 1) concatenation with other layers' outputs, the
    JAX package's contract: the pair form gives ``[x, H0]``, the list form
    the listed layers' outputs side by side (the reference declares axis 1
    but concatenates on axis 0, layers.py:93-101)."""

    def build(self, net: Network, H0: Union[Layer, List[Layer]]):
        self.H0 = H0
        n = net.top_shape()[0]
        sources = H0 if isinstance(H0, list) else [H0]
        for H in sources:
            if H.output_shape[0] != n:
                raise ValueError(
                    f"Mismatching first dimension to concatenate: "
                    f"{net.top_shape()} vs {H.output_shape}")
        if isinstance(H0, list):
            return (n, sum(H.output_shape[1] for H in H0))
        return (n, net.top_shape()[1] + H0.output_shape[1])

    def apply(self, fw: Forward, x):
        if isinstance(self.H0, list):
            return torch.cat([fw.value_of(H) for H in self.H0], dim=1)
        return torch.cat([x, fw.value_of(self.H0)], dim=1)


class Tradeoff(Layer):
    """Sigmoid-weighted convex combination of layer outputs, the weights
    learnable (zero-init scalars) or fixed (reference layers.py:104-122)."""

    def build(self, net: Network, layers: Sequence[Layer], weights=None,
              trainable: bool = True):
        shape = layers[0].output_shape
        if any(layer.output_shape != shape for layer in layers):
            raise ValueError("Mismatching trade-off dimensions")
        self.sources = list(layers)
        if weights is None:
            self.weight_params = [
                net.create_param((1, 1), "zero", trainable=trainable,
                                 regularize=True) for _ in layers]
            self.fixed_weights = None
        else:
            self.weight_params = None
            self.fixed_weights = [torch.as_tensor(w, dtype=torch.float32,
                                                  device=net.device)
                                  for w in weights]
        return shape

    def apply(self, fw: Forward, x):
        if self.weight_params is not None:
            ws = [torch.sigmoid(fw.param(p)) for p in self.weight_params]
        else:
            ws = [torch.sigmoid(w) for w in self.fixed_weights]
        total = sum(ws)
        out = 0.0
        for w, layer in zip(ws, self.sources):
            out = out + w * fw.value_of(layer) / total
        return out


class Wrap(Layer):
    """Adapts a ``torch.nn.Module`` (reference layers.py:45-65 wraps Keras
    layers; the JAX package a flax module).  ``module`` is a module or a
    module class, built with ``*args, **kwargs`` under a generator seeded
    with ``rng``.  Its parameters join the model's registry as
    ``wrap{index}_{i}`` in ``named_parameters()`` order (a parameter of
    fewer than 2 dimensions as ``(1, ...)``), initialized to the module's
    own values, so ``reset()`` restarts from them; the forward calls the
    module with the registry's tensors (``torch.func.functional_call``)."""

    def build(self, net: Network, module, *args, dropout: float = 0.0,
              regularize: bool = False, rng: int = 0, **kwargs):
        n, d = net.top_shape()
        if isinstance(module, type):
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(rng)
                module = module(*args, **kwargs)
        self.module = module.to(net.device)
        self.leaf_names = []
        for i, (pname, p) in enumerate(self.module.named_parameters()):
            shape = tuple(p.shape)
            reg_shape = shape if len(shape) >= 2 else (1,) + shape
            name = net.create_param(
                reg_shape, p.detach().cpu().numpy().reshape(reg_shape),
                regularize=regularize, name=f"wrap{self.index}_{i}")
            self.leaf_names.append((pname, name, shape))
        with torch.no_grad():
            out = self.module(torch.zeros(1, d, dtype=net.dtype,
                                          device=net.device))
        self.dropout_rate = dropout
        return (n, int(out.shape[-1]))

    def apply(self, fw: Forward, x):
        params = {pname: fw.param(name).reshape(shape)
                  for pname, name, shape in self.leaf_names}
        out = torch.func.functional_call(self.module, params, (x,))
        return fw.dropout(out, self.dropout_rate)


class LSTM(Layer):
    """LSTM over integer token sequences (batch, T) with an embedding
    table, emitting ``[h; c]`` (reference layers.py:5-42), a loop over the
    time steps; its layer loss is 0 (layers.py:41-42)."""

    def build(self, net: Network, dims: int, dict_size: int):
        v = net.create_param
        self.Wf, self.Uf = (v((dims, dims), regularize=100),
                            v((dims, dims), regularize=100))
        self.bf = v((1, dims), "zero", regularize=False)
        self.Wi, self.Ui = (v((dims, dims), regularize=100),
                            v((dims, dims), regularize=100))
        self.bi = v((1, dims), "zero", regularize=False)
        self.Wo, self.Uo = (v((dims, dims), regularize=100),
                            v((dims, dims), regularize=100))
        self.bo = v((1, dims), "zero", regularize=False)
        self.Wc, self.Uc = (v((dims, dims), regularize=100),
                            v((dims, dims), regularize=100))
        self.bc = v((1, dims), "zero", regularize=False)
        self.embeddings = v((dict_size, dims))
        self.dims = dims
        return (net.top_shape()[0], dims * 2)

    def apply(self, fw: Forward, tokens):
        p = fw.param
        emb = p(self.embeddings)
        tokens = tokens.to(torch.int64)
        h = torch.zeros(tokens.shape[0], self.dims, dtype=emb.dtype,
                        device=emb.device)
        c = torch.zeros_like(h)
        for t in range(tokens.shape[1]):
            xt = emb[tokens[:, t]]
            f = torch.sigmoid(xt @ p(self.Wf) + h @ p(self.Uf) + p(self.bf))
            o = torch.sigmoid(xt @ p(self.Wo) + h @ p(self.Uo) + p(self.bo))
            i = torch.sigmoid(xt @ p(self.Wi) + h @ p(self.Ui) + p(self.bi))
            g = torch.tanh(xt @ p(self.Wc) + h @ p(self.Uc) + p(self.bc))
            c = f * c + i * g
            h = o * torch.tanh(c)
        return torch.cat([h, c], dim=1)

    def loss(self, fw, value):
        return 0.0
