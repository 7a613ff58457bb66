"""Config dataclasses (the JAX package's ``config.py``).

The reference's configuration surface is its kwarg defaults
(train(): trainable.py:41-52; per-model hyperparameters: filter.py:27-28,
gcn.py:56-66,108-113).  These dataclasses freeze those exact schemas and
add a flat ``from_flags`` CLI bridge, so experiments are reproducible from
a single serializable object.  The fields, flags and JSON are the JAX
package's; each ``build`` makes the port's model on ``device`` (default
``"cuda"``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass
class TrainConfig:
    """Mirrors Trainable.train's signature defaults (trainable.py:41-52)."""
    patience: int = 100
    learning_rate: float = 0.01
    regularization: float = 5.0e-4
    epochs: int = 2000
    batches: int = 1
    verbose: bool = False
    seed: Optional[int] = None
    block_epochs: int = 1
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 25
    resume: bool = False

    def kwargs(self) -> dict:
        return dataclasses.asdict(self)


@dataclass
class APPNPConfig:
    """filter.py:27-28 defaults."""
    latent_dims: Sequence[int] = (64,)
    alpha: Optional[float] = 0.1   # None => learnable restart (filter.py:35)
    iterations: int = 10
    dropout: float = 0.6
    graph_dropout: float = 0.5

    def build(self, graph, features, num_classes: int, device="cuda"):
        from .models import APPNP
        return APPNP(graph, features, num_classes=num_classes,
                     latent_dims=list(self.latent_dims), a=self.alpha,
                     iterations=self.iterations, dropout=self.dropout,
                     graph_dropout=self.graph_dropout, device=device)


@dataclass
class GCNConfig:
    """gcn.py:108-113 defaults."""
    latent_dims: Sequence[int] = (64,)
    dropout: float = 0.5
    graph_dropout: float = 0.5

    def build(self, graph, features, num_classes: int, device="cuda"):
        from .models import GCN
        return GCN(graph, features, num_classes=num_classes,
                   latent_dims=list(self.latent_dims), device=device)


@dataclass
class GCNIIConfig:
    """gcn.py:54-66 defaults."""
    latent_dims: Sequence[int] = (64,)
    alpha: float = 0.1
    l: float = 0.5
    iterations: int = 64
    dropout: float = 0.6

    def build(self, graph, features, num_classes: int, device="cuda"):
        from .models import GCNII
        return GCNII(graph, features, num_classes=num_classes,
                     latent_dims=list(self.latent_dims), a=self.alpha,
                     l=self.l, iterations=self.iterations,
                     dropout=self.dropout, device=device)


@dataclass
class GATConfig:
    latent_dims: Sequence[int] = (8,)
    heads: int = 8
    dropout: float = 0.6

    def build(self, graph, features, num_classes: int, device="cuda"):
        from .models import GAT
        return GAT(graph, features, num_classes=num_classes,
                   latent_dims=list(self.latent_dims), heads=self.heads,
                   dropout=self.dropout, device=device)


@dataclass
class GraphSAGEConfig:
    latent_dims: Sequence[int] = (64,)
    dropout: float = 0.5
    normalize: bool = False

    def build(self, graph, features, num_classes: int, device="cuda"):
        from .models import GraphSAGE
        return GraphSAGE(graph, features, num_classes=num_classes,
                         latent_dims=list(self.latent_dims),
                         dropout=self.dropout, normalize=self.normalize,
                         device=device)


@dataclass
class GINConfig:
    latent_dims: Sequence[int] = (64,)
    dropout: float = 0.5
    train_eps: bool = True

    def build(self, graph, features, num_classes: int, device="cuda"):
        from .models import GIN
        return GIN(graph, features, num_classes=num_classes,
                   latent_dims=list(self.latent_dims), dropout=self.dropout,
                   train_eps=self.train_eps, device=device)


MODEL_CONFIGS = {
    "appnp": APPNPConfig,
    "gcn": GCNConfig,
    "gcnii": GCNIIConfig,
    "gat": GATConfig,
    "sage": GraphSAGEConfig,
    "gin": GINConfig,
}


def add_flags(parser: argparse.ArgumentParser, cls) -> None:
    """Register one CLI flag per dataclass field (lists comma-separated)."""
    for f in dataclasses.fields(cls):
        name = "--" + f.name.replace("_", "-")
        default = f.default if f.default is not dataclasses.MISSING else None
        if f.type in (bool, "bool"):
            parser.add_argument(name, type=lambda s: s.lower() in
                                ("1", "true", "yes"), default=default)
        elif "Sequence" in str(f.type) or "List" in str(f.type):
            parser.add_argument(
                name, type=lambda s: [int(x) for x in s.split(",")],
                default=list(default) if default is not None else None)
        else:
            base = {int: int, float: float, str: str}.get(f.type, None)
            if base is None:
                base = (float if "float" in str(f.type)
                        else int if "int" in str(f.type) else str)
            parser.add_argument(name, type=base, default=default)


def from_flags(cls, namespace: argparse.Namespace):
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: v for k, v in vars(namespace).items()
          if k in names and v is not None}
    return cls(**kw)


def to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), sort_keys=True)
