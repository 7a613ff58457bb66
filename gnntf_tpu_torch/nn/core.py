"""The layer engine: an imperative model builder over an ``nn.Module``.

As in the reference (gnntf/core/nn/layered.py), ``add()`` infers shapes
eagerly and layers register parameters by name.  Parameters live in one
``nn.ParameterDict`` keyed by the JAX package's names (``p0``, ``p1``, …) in
the same registration order, so weights map one to one between the two
packages.  ``forward(x)`` folds the layers in order and keeps every layer's
output in a :class:`Forward` context, which residual layers read back
(the reference's ``.value`` cache).

Randomness in training: the step passes one CPU ``torch.Generator``; each
layer draws its own CPU generator from it, in layer order, and the layer's
stochastic ops draw from that.  Edge dropout takes its salts from the CPU
generator, so a step's edge masks are the same on every device; feature
dropout seeds a generator on the model's device; a layer's own draws come
from a fresh generator seeded the same way (``Forward.next_generator``).
The fused trainer passes a :class:`DrawTape` instead, which records those
draws once and then feeds each epoch's draws to a forward that reads them
from fixed places.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..utils.device import resolve_device
from .initializers import init_param


class ParamSpec:
    """Metadata for one parameter (reference: WrappedVariable fields,
    variables.py:4-10)."""

    __slots__ = ("name", "shape", "init", "trainable", "regularize")

    def __init__(self, name, shape, init="small", trainable=True,
                 regularize=True):
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.init = init
        self.trainable = bool(trainable)
        self.regularize = float(regularize)


class Layer:
    """Base layer protocol: ``build(net, ...) -> output_shape`` registers
    parameters via ``net.create_param``; ``apply(fw, x) -> y``."""

    def __init__(self, *args, output_regularize: float = 0.0, **kwargs):
        self._args = args
        self._kwargs = kwargs
        self.output_regularize = float(output_regularize)
        self.index: Optional[int] = None
        self.output_shape: Optional[Tuple[int, ...]] = None

    def late_init(self, net: "Network") -> None:
        prev = len(net.param_specs)
        self.output_shape = self.build(net, *self._args, **self._kwargs)
        if self.output_shape is None:
            raise ValueError(
                f"{type(self).__name__}.build must return an output shape")
        self.output_shape = tuple(int(s) for s in self.output_shape)
        self.param_names = [s.name for s in net.param_specs[prev:]]
        self._args = None
        self._kwargs = None

    def build(self, net: "Network", *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} must implement build()")

    def apply(self, fw: "Forward", x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            f"{type(self).__name__} must implement apply()")

    def loss(self, fw: "Forward", value: torch.Tensor):
        """Activation-regularization loss, ``output_regularize * l2(value)``
        (reference Layer.loss, layered.py:83-86)."""
        if self.output_regularize == 0.0:
            return 0.0
        return self.output_regularize * 0.5 * torch.sum(
            torch.square(value.to(torch.float32)))


def _draw_seed(generator: torch.Generator) -> int:
    return int(torch.randint(0, 1 << 62, (1,), generator=generator))


def _generator_at(state: torch.Tensor) -> torch.Generator:
    """A CPU generator in ``state``."""
    generator = torch.Generator()
    generator.set_state(state)
    return generator


class DrawTape:
    """The random draws of a training forward, recorded once so that every
    later epoch's draws can be fed to a forward that reads them from fixed
    places: the fused trainer's captured epoch (``train/trainer.py``).

    Recording (:meth:`record`), the forward draws as the host loop does: a
    CPU generator a layer, drawn from the epoch's generator, and from it
    each stochastic op's draw, two edge-dropout salts, a generator's seed
    (a feature dropout's, or :meth:`Forward.next_generator`'s) or an eager
    edge mask's uniforms; the tape keeps their kinds in order.  Replaying
    (after :meth:`stop`), the forward reads each salt pair from its slot of
    :attr:`salts`, each generator is the op's own (made once, while
    recording, so a CUDA graph can register it) and each eager mask's
    uniforms are row :attr:`row` of the mask's table in :attr:`uniforms`.
    A recompute under remat draws from a twin of each generator
    (:attr:`twins`), seeded alike, so that no generator is ever rewound.
    :meth:`draw` reruns the record on the host on an epoch's generator;
    :meth:`fill` writes epochs' uniforms into the tables, :meth:`feed`
    seeds the generators, and the caller copies the salts into
    :attr:`salts`.  A forward whose draws differ from the record raises."""

    def __init__(self):
        # the kinds a layer draws: "salt", "seed" or ("uniform", n)
        self.layers: List[list] = []
        self.generators: List[torch.Generator] = []
        self.twins: Dict[int, torch.Generator] = {}
        self.salts: Optional[torch.Tensor] = None  # (K, 2) int64 slots
        # while recording each eager mask's uniforms; after stop, its
        # (rows, n) table
        self.uniforms: List[torch.Tensor] = []
        self.row: Optional[torch.Tensor] = None  # (1,) int64, the table row
        self._epoch = None  # the epoch's generator while recording
        self._layer = None  # the layer's generator while recording
        self.begin_forward()

    @property
    def recording(self) -> bool:
        return self._epoch is not None

    def record(self, generator: torch.Generator) -> None:
        """Record the next forward's draws, made from ``generator``."""
        self.layers, self.generators, self.uniforms = [], [], []
        self.twins = {}
        self._epoch = generator

    def stop(self, device, rows: int = 1,
             row: Optional[torch.Tensor] = None) -> None:
        """End the recording: the salt slots and a table of ``rows`` rows
        for each eager mask's uniforms are made on ``device``; a replayed
        forward reads the table row that ``row`` (a (1,) int64 tensor on
        ``device``, updated in place) holds, row 0 without one."""
        self._epoch = self._layer = None
        n = sum(kind == "salt" for kinds in self.layers for kind in kinds)
        self.salts = torch.zeros(n, 2, dtype=torch.int64, device=device)
        self.uniforms = [torch.zeros(rows, u.shape[0], dtype=u.dtype,
                                     device=device) for u in self.uniforms]
        self.row = torch.zeros(1, dtype=torch.int64, device=device) \
            if row is None else row

    def begin_forward(self) -> None:
        self._layer_at, self._op_at = -1, 0
        self._drawn = {"salt": 0, "seed": 0, "uniform": 0}
        self._handed = set()  # the generators this forward has handed out

    def begin_layer(self) -> None:
        self._layer_at, self._op_at = self._layer_at + 1, 0
        if self.recording:
            self._layer = torch.Generator().manual_seed(
                _draw_seed(self._epoch))
            self.layers.append([])
        elif self._layer_at >= len(self.layers):
            raise RuntimeError("the forward has more layers than the "
                               "recorded one")

    def _next(self, kind) -> int:
        """The index of this op's draw among those of its kind, its kind
        recorded or checked against the record (a recompute under remat
        checks the ops its layer recorded)."""
        ops = self.layers[self._layer_at]
        if self.recording and self._op_at == len(ops):
            ops.append(kind)
        elif self._op_at >= len(ops) or ops[self._op_at] != kind:
            raise RuntimeError(
                f"layer {self._layer_at} draws {kind!r} as its op "
                f"{self._op_at}, unlike the recorded forward")
        self._op_at += 1
        name = kind if isinstance(kind, str) else kind[0]
        self._drawn[name] += 1
        return self._drawn[name] - 1

    def salt(self, device) -> torch.Tensor:
        """An edge dropout's salt pair on ``device``."""
        from ..ops.stochastic import draw_salt
        i = self._next("salt")
        if self.recording:
            return draw_salt(self._layer, device)
        return self.salts[i]

    def generator(self, device) -> torch.Generator:
        """The generator of a feature dropout's mask, or of a layer's own
        draws, on ``device``: the op's slot, seeded from the layer's CPU
        generator; the slot's twin when the op draws again in the same
        forward (a recompute under remat)."""
        seed = _draw_seed(self._layer) if self.recording else None
        i = self._next("seed")
        if i in self._handed:
            if i not in self.twins:
                if not self.recording:
                    raise RuntimeError(
                        f"generator {i} is drawn again, unlike the "
                        "recorded forward")
                self.twins[i] = torch.Generator(device=device)
            generator = self.twins[i]
        else:
            if self.recording:
                self.generators.append(torch.Generator(device=device))
            generator = self.generators[i]
        if self.recording:
            generator.manual_seed(seed)
        self._handed.add(i)
        return generator

    def uniform(self, n: int, device) -> torch.Tensor:
        """An eager edge mask's ``n`` uniforms on ``device``."""
        i = self._next(("uniform", n))
        if self.recording:
            drawn = torch.rand(n, generator=self._layer)
            if i == len(self.uniforms):
                self.uniforms.append(drawn)
            return drawn.to(device)
        return self.uniforms[i].index_select(0, self.row)[0]

    def draw(self, generator: torch.Generator):
        """The recorded forward's draws on ``generator``, as the host loop
        makes them: ``(salts, seeds, uniforms)``, the salts a (K, 2) int64
        host tensor in slot order."""
        from ..ops.stochastic import host_salt
        salts, seeds, uniforms = [], [], []
        for kinds in self.layers:
            layer = torch.Generator().manual_seed(_draw_seed(generator))
            for kind in kinds:
                if kind == "salt":
                    salts.append(host_salt(layer))
                elif kind == "seed":
                    seeds.append(_draw_seed(layer))
                else:
                    uniforms.append(torch.rand(kind[1], generator=layer))
        salts = torch.stack(salts) if salts else torch.zeros(
            0, 2, dtype=torch.int64)
        return salts, seeds, uniforms

    def mark(self):
        """Where the tape stands in the current layer, and the state of the
        layer's CPU generator while recording: :meth:`rewind` returns there,
        so that a recompute under remat draws the layer's draws again."""
        layer = None if self._layer is None else self._layer.get_state()
        return self._layer_at, self._op_at, dict(self._drawn), layer

    def rewind(self, mark) -> None:
        self._layer_at, self._op_at, drawn, layer = mark
        self._drawn = dict(drawn)
        if layer is not None:
            self._layer = _generator_at(layer)

    def fill(self, row: int, uniforms) -> None:
        """Write forwards' uniforms (a list of :meth:`draw`'s third item,
        one a forward) into the tables from ``row`` on: one copy a
        table."""
        for j, table in enumerate(self.uniforms):
            table[row:row + len(uniforms)].copy_(
                torch.stack([u[j] for u in uniforms]))

    def feed(self, seeds, uniforms=()) -> None:
        """Seed each generator and its twin for the next replayed forward;
        ``uniforms`` (one forward's, from :meth:`draw`) go into row 0 of
        the tables."""
        for i, (generator, seed) in enumerate(zip(self.generators, seeds)):
            generator.manual_seed(seed)
            if i in self.twins:
                self.twins[i].manual_seed(seed)
        if uniforms:
            self.fill(0, [uniforms])


class Forward:
    """Per-call forward context: the mode, the random state and each
    layer's output."""

    __slots__ = ("net", "training", "acts", "extra_losses", "graph",
                 "_generator", "_layer_generator", "_tape")

    def __init__(self, net: "Network", training: bool, generator=None,
                 graph=None):
        """``generator``: the step's CPU generator, or a :class:`DrawTape`
        (the fused trainer's).  ``graph`` overrides the model's adjacency
        for this forward."""
        self.net = net
        self.graph = graph if graph is not None \
            else getattr(net, "graph", None)
        self.training = bool(training)
        self.acts: List[torch.Tensor] = []
        self.extra_losses: List[torch.Tensor] = []
        self._tape = generator if isinstance(generator, DrawTape) else None
        self._generator = None if self._tape is not None else generator
        self._layer_generator = None
        if self._tape is not None:
            self._tape.begin_forward()

    def begin_layer(self) -> None:
        """Draw the layer's CPU generator from the step's."""
        if self._tape is not None:
            self._tape.begin_layer()
        elif self._generator is not None:
            self._layer_generator = torch.Generator().manual_seed(
                _draw_seed(self._generator))

    def draw_point(self):
        """What the current layer's draws depend on: the layer's CPU
        generator's state, or the tape's :meth:`DrawTape.mark`."""
        if self._tape is not None:
            return self._tape.mark()
        if self._layer_generator is None:
            return None
        return self._layer_generator.get_state()

    def rewind(self, point) -> None:
        """Return to ``point`` (from :meth:`draw_point`), so that the
        layer's ops draw what they drew from there."""
        if self._tape is not None:
            self._tape.rewind(point)
        elif point is not None:
            self._layer_generator = _generator_at(point)

    def _stream(self) -> torch.Generator:
        """The layer's CPU generator, which the layer's draws are made
        from."""
        if self._layer_generator is None:
            raise ValueError(
                "Stochastic op requested without a generator; pass "
                "generator= to forward() when training=True")
        return self._layer_generator

    def next_generator(self, device=None) -> torch.Generator:
        """A fresh generator for a stochastic op of the layer, on
        ``device`` (the CPU by default), seeded by a draw from the layer's
        stream as a feature dropout's is: the counterpart of the JAX
        package's ``next_rng()``, each call a generator of its own.  Under
        the fused trainer (a :class:`DrawTape`) it is the tape's slot for
        the draw, seeded anew before each replayed forward; on a card it
        must lie on the card (``device=``), since a CUDA graph replays no
        CPU draw."""
        device = torch.device("cpu" if device is None else device)
        if self._tape is not None:
            if device.type == "cpu" and self.net.device.type != "cpu":
                raise ValueError(
                    "fit(block_epochs > 1) on a card replays the epoch in a "
                    "CUDA graph, which cannot replay a CPU generator's "
                    "draws: pass device= (the model's device) to "
                    "next_generator()")
            return self._tape.generator(device)
        return torch.Generator(device=device).manual_seed(
            _draw_seed(self._stream()))

    def param(self, ref) -> torch.Tensor:
        return self.net.param(ref)

    def value_of(self, layer: Layer) -> torch.Tensor:
        """Another layer's output in *this* forward pass."""
        if layer.index is None or layer.index >= len(self.acts):
            raise ValueError(
                "value_of() may only reference layers earlier in the stack")
        return self.acts[layer.index]

    def add_loss(self, value) -> None:
        """A layer's own loss term, summed by ``Network.layer_losses``."""
        self.extra_losses.append(value)

    def dropout(self, x: torch.Tensor, rate: float = 0.5) -> torch.Tensor:
        """Feature dropout: the identity outside training; in training the
        mask comes from a generator on ``x``'s device, seeded from the
        layer's CPU generator (or the tape's generator for the op)."""
        if not self.training or rate == 0.0:
            return x
        from ..ops.dropout import dropout
        if self._tape is not None:
            generator = self._tape.generator(x.device)
        else:
            generator = torch.Generator(device=x.device).manual_seed(
                _draw_seed(self._stream()))
        return dropout(x, rate, generator)

    def attention_salt(self) -> torch.Tensor:
        """An attention dropout's salt pair on the model's device
        (``ops/attention.py``), drawn as edge dropout's: from the layer's
        CPU generator, or from the :class:`DrawTape`'s slot."""
        from ..ops.stochastic import draw_salt
        return draw_salt(self._tape if self._tape is not None
                         else self._stream(), self.net.device)

    def adjacency(self, graph_dropout: float = 0.5,
                  normalized: str = "symmetric", add_eye: str = "none"):
        """The normalized adjacency (reference GNN.get_adjacency,
        gnn.py:36-50): in training with ``graph_dropout``, a fresh edge
        dropout renormalized after the draw; otherwise the model's cached
        one (for a ``graph`` override, its normalization)."""
        if self.graph is None:
            raise ValueError("adjacency() requires a graph-bearing model (GNN)")
        from ..ops.normalize import normalize_adjacency
        if self.training and graph_dropout != 0.0:
            return normalize_adjacency(
                self.graph, graph_dropout=graph_dropout,
                normalized=normalized, add_eye=add_eye,
                generator=(self._tape if self._tape is not None
                           else self._stream()))
        if self.graph is getattr(self.net, "graph", None):
            return self.net.adjacency(normalized, add_eye)
        return normalize_adjacency(self.graph, graph_dropout=0.0,
                                   normalized=normalized, add_eye=add_eye)

    def spmm(self, graph, x: torch.Tensor) -> torch.Tensor:
        """``graph @ x`` through the model's prepared operator for it."""
        return self.net.operator(graph)(x)


class Network(nn.Module):
    """Ordered layer container + parameter registry (reference
    ``Layered(VariableGenerator)``, layered.py:5-55, variables.py:48-67).
    Parameters are allocated at registration (zeros, like the reference)
    and drawn by :meth:`init`."""

    def __init__(self, input_shape: Sequence[int], device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.input_shape = tuple(int(s) for s in input_shape)
        self._layers: List[Layer] = []
        self.param_specs: List[ParamSpec] = []
        self._shared: Dict[str, str] = {}
        self.dtype = torch.float32
        self.params = nn.ParameterDict()
        # while fit(mesh=) holds column blocks of the hidden weights
        # (parallel.dist.place_state): their gathers
        self.shards = None

    def layers(self) -> List[Layer]:
        return self._layers

    def top_layer(self) -> Layer:
        return self._layers[-1]

    def top_shape(self) -> Tuple[int, ...]:
        if not self._layers:
            return self.input_shape
        return self._layers[-1].output_shape

    def add(self, layer: Layer) -> Layer:
        """Append ``layer`` (built here); a layer already in the stack is
        re-emitted through an :class:`_Alias`, as the reference allows
        duplicate membership (layered.py:25-29)."""
        if layer.index is not None:
            layer = _Alias(layer)
        layer.index = len(self._layers)
        layer.late_init(self)
        self._layers.append(layer)
        return layer

    def create_param(self, shape, normalization="small", trainable=True,
                     regularize=True, name=None, shared_name=None) -> str:
        """Register a parameter; returns its name (the handle layers store):
        ``name``, or ``p<i>`` in registration order as in the JAX package,
        with ``_<i>`` appended where the name is taken.  A ``shared_name``
        seen before returns that parameter's name and registers nothing
        (reference variables.py:56-58)."""
        if shared_name is not None and shared_name in self._shared:
            return self._shared[shared_name]
        pname = name or f"p{len(self.param_specs)}"
        if any(s.name == pname for s in self.param_specs):
            pname = f"{pname}_{len(self.param_specs)}"
        if shared_name is not None:
            self._shared[shared_name] = pname
        spec = ParamSpec(pname, shape, normalization, trainable, regularize)
        self.param_specs.append(spec)
        self.params[pname] = nn.Parameter(
            torch.zeros(spec.shape, dtype=self.dtype, device=self.device),
            requires_grad=spec.trainable)
        return pname

    def create_var(self, shape=None, normalization="small", trainable=True,
                   regularize=True, name=None, shared_name=None):
        """Reference name (create_var, variables.py:55); no shape gives the
        (1, 1) scalar of APPNP's learnable restart probability."""
        if shape is None:
            shape = (1, 1)
        return self.create_param(shape, normalization, trainable, regularize,
                                 name=name, shared_name=shared_name)

    @torch.no_grad()
    def init(self, seed: Union[int, torch.Generator]) -> None:
        """Draw every parameter in registration order from one CPU
        generator (the reference's ``reset()``, variables.py:65-67)."""
        generator = seed if isinstance(seed, torch.Generator) \
            else torch.Generator().manual_seed(int(seed))
        for spec in self.param_specs:
            self.params[spec.name].copy_(
                init_param(generator, spec.shape, spec.init, self.dtype))

    def forward(self, x: torch.Tensor, *, training: bool = False,
                generator=None, return_ctx: bool = False,
                remat: bool = False, graph=None):
        """Sequential forward fold (layered.py:52-55).  ``generator`` is the
        step's CPU generator (or a :class:`DrawTape`), needed when
        ``training`` draws dropout.  ``graph`` overrides the model-bound
        adjacency for this forward (the JAX package's ``apply(graph=)``).

        ``remat=True`` runs each layer under ``torch.utils.checkpoint``: the
        backward recomputes the layer's internals instead of keeping them.
        The recompute starts from the layer's :meth:`Forward.draw_point`, so
        it draws the same masks and salts as the forward did.  A layer that
        calls :meth:`Forward.add_loss` raises ``ValueError``."""
        fw = Forward(self, training, generator, graph)
        h = x
        for layer in self._layers:
            fw.begin_layer()
            h = _remat(fw, layer, h) if remat else layer.apply(fw, h)
            fw.acts.append(h)
        if return_ctx:
            return h, fw
        return h

    def layer_losses(self, fw: Forward):
        """Sum of the per-layer losses and of the losses the layers added
        with :meth:`Forward.add_loss` (trainable.py:72-74)."""
        total = 0.0
        for layer, act in zip(self._layers, fw.acts):
            total = total + layer.loss(fw, act)
        for extra in fw.extra_losses:
            total = total + extra
        return total

    def param(self, name: str) -> torch.Tensor:
        """Parameter ``name`` whole: a column block that ``fit(mesh=)``
        holds (``parallel.dist.FeatShards``) gathered over the ``feat``
        group, its gradient this rank's columns."""
        p = self.params[name]
        return p if self.shards is None else self.shards.whole(name, p)

    def weight_l2(self):
        """``sum_var reg_weight * l2_loss(var)``; the trainer multiplies it by
        the global ``regularization`` factor (trainable.py:75-77)."""
        total = 0.0
        for spec in self.param_specs:
            if spec.regularize != 0.0:
                w = self.param(spec.name)
                total = total + spec.regularize * 0.5 * torch.sum(
                    torch.square(w.to(torch.float32)))
        return total

    def trainable_mask(self) -> Dict[str, bool]:
        return {s.name: s.trainable for s in self.param_specs}


def _remat(fw: Forward, layer: Layer, h: torch.Tensor) -> torch.Tensor:
    """``layer.apply(fw, h)`` under ``torch.utils.checkpoint``, each run
    rewound to the layer's draw point."""
    from torch.utils.checkpoint import checkpoint
    point = fw.draw_point()
    n_losses = len(fw.extra_losses)

    def run(h):
        fw.rewind(point)
        return layer.apply(fw, h)

    # every draw of the port names its generator, so checkpoint need not
    # stash the default ones (a CUDA graph could not read them)
    out = checkpoint(run, h, use_reentrant=False, preserve_rng_state=False)
    if len(fw.extra_losses) != n_losses:
        raise ValueError(
            f"{type(layer).__name__} emits add_loss() side outputs, which "
            "cannot escape a remat scope — train with remat=False")
    return out


class _Alias(Layer):
    """A layer added to the stack a second time: its output there is the
    inner layer applied again, with the inner layer's parameters."""

    def __init__(self, inner: Layer):
        super().__init__()
        self.inner = inner

    def build(self, net: Network):
        return self.inner.output_shape

    def apply(self, fw: Forward, x: torch.Tensor) -> torch.Tensor:
        return self.inner.apply(fw, x)
