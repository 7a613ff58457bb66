"""Training and inference for a network bound to one feature matrix
(reference gnntf/core/nn/trainable.py).

``fit`` is the host loop of the reference ``Trainable.train``
(trainable.py:41-103):

* fresh parameters at the start of every call (or ``init_params``);
* Adam with the Keras epsilon placement (:func:`keras_adam`);
* ``valid = train`` when no validation task is given;
* per epoch, ``batches`` x {forward with dropout, task loss + per-layer
  losses + ``regularization`` x weight L2, gradients of
  ``loss * degradation(epoch)``, optimizer update}, then a clean
  (dropout-off) forward for the validation loss;
* early stopping on the validation loss with a patience counter, a snapshot
  of the parameters at every strict improvement, and the best snapshot
  restored at the end.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from .. import measures
from ..nn.core import Network
from ..ops.spmm import _IMPL_NAMES, spmm_impl as _impl_scope
from ..tasks.base import Predictor
from ..utils.device import resolve_device


class KerasAdam:
    """Adam with Keras' update rule (the reference uses
    ``tf.keras.optimizers.Adam(lr)``, trainable.py:56-57):

        alpha = lr * sqrt(1 - b2^t) / (1 - b1^t)
        var  -= alpha * m / (sqrt(v) + eps)

    The epsilon is added to the uncorrected ``sqrt(v)``, outside the bias
    correction — unlike ``torch.optim.Adam``, which adds it to
    ``sqrt(v_hat)``.  ``init``/``update`` work on dicts of tensors, as the
    JAX package's optax transformation works on its parameter pytree."""

    def __init__(self, learning_rate: float = 0.01, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-7):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Mapping[str, torch.Tensor]):
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
        return {"count": 0, "m": zeros(), "v": zeros()}

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state):
        """``(updates, new_state)``: the updates are added to the
        parameters."""
        b1, b2 = self.b1, self.b2
        count = state["count"] + 1
        m = {k: b1 * state["m"][k] + (1.0 - b1) * g for k, g in grads.items()}
        v = {k: b2 * state["v"][k] + (1.0 - b2) * torch.square(g)
             for k, g in grads.items()}
        t = torch.tensor(float(count), dtype=torch.float32)
        f32 = lambda a: torch.tensor(a, dtype=torch.float32)
        alpha = float(f32(self.learning_rate) * torch.sqrt(
            1.0 - torch.pow(f32(b2), t)) / (1.0 - torch.pow(f32(b1), t)))
        updates = {k: -alpha * m[k] / (torch.sqrt(v[k]) + self.eps)
                   for k in grads}
        return updates, {"count": count, "m": m, "v": v}


def keras_adam(learning_rate: float = 0.01, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-7) -> KerasAdam:
    return KerasAdam(learning_rate, b1, b2, eps)


class Trainable(Network):
    """A network bound to one feature matrix at construction (reference
    trainable.py:17-20: "the architecture is defined for specific input
    data")."""

    def __init__(self, features, device="cuda"):
        device = resolve_device(device)
        features = torch.as_tensor(features, dtype=torch.float32,
                                   device=device)
        super().__init__(features.shape, device)
        self.features = features
        self.initialized = False
        self._act_cache = None  # clean-forward cache (trainable.py:26-39)

    def reset(self, seed: Optional[int] = None) -> None:
        """Draw fresh parameters (from ``measures.next_seed()`` when no seed
        is given) and drop the cached activations."""
        self.init(measures.next_seed() if seed is None else seed)
        self.initialized = True
        self._act_cache = None

    def _activations(self) -> torch.Tensor:
        if not self.initialized:
            self.reset()
        if self._act_cache is None:
            with torch.no_grad():
                self._act_cache = self.forward(self.features, training=False)
        return self._act_cache

    def predict(self, predictor: Predictor):
        predictor.refresh()
        return predictor.predict(self._activations(), predictor.batch(),
                                 params=self.params)

    def loss(self, predictor: Predictor):
        predictor.refresh()
        return predictor.loss(self._activations(), predictor.batch(),
                              params=self.params)

    def evaluate(self, predictor: Predictor):
        predictor.refresh()
        return predictor.evaluate(self._activations(), predictor.batch(),
                                  params=self.params)

    def train(self, train: Predictor, valid: Optional[Predictor] = None,
              test: Optional[Predictor] = None, patience: int = 100,
              learning_rate: float = 0.01, regularization: float = 5.0e-4,
              verbose: bool = False, epochs: int = 2000,
              degradation: Callable[[int], float] = lambda epoch: 1,
              batches: int = 1, optimizer=None, seed: Optional[int] = None,
              block_epochs: int = 1, callbacks=(),
              checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 25, resume: bool = False, mesh=None,
              spmm: Optional[str] = None, spmm_impl: Optional[str] = None,
              init_params=None, remat: bool = False):
        return fit(self, train, valid=valid, test=test, patience=patience,
                   learning_rate=learning_rate, regularization=regularization,
                   verbose=verbose, epochs=epochs, degradation=degradation,
                   batches=batches, optimizer=optimizer, seed=seed,
                   block_epochs=block_epochs, callbacks=callbacks,
                   checkpoint_dir=checkpoint_dir,
                   checkpoint_every=checkpoint_every, resume=resume,
                   mesh=mesh, spmm=spmm, spmm_impl=spmm_impl,
                   init_params=init_params, remat=remat)


def _fold_in(seed: int, index: int) -> int:
    """A 64-bit seed for step ``index`` of a run seeded with ``seed``."""
    return int(np.random.SeedSequence([seed, index]).generate_state(
        1, np.uint64)[0])


def _unported(**options):
    """Raise for the options of the JAX package's ``fit`` that the port
    does not have yet (ROADMAP.md, queue 1)."""
    where = {"mesh": "item 16 (scale-out)",
             "spmm": "item 16 (scale-out executors)",
             "checkpoint_dir": "item 15 (utils/checkpoint.py)",
             "resume": "item 15 (utils/checkpoint.py)",
             "remat": "item 9 (trainer: remat)",
             "block_epochs": "item 9 (trainer: the fused multi-epoch path)"}
    for name, value in options.items():
        if value:
            raise NotImplementedError(
                f"fit({name}=...) is not ported yet: ROADMAP.md queue 1, "
                f"{where[name]}")


def _total_loss(model: Trainable, task: Predictor, batch, regularization,
                generator):
    out, fw = model.forward(model.features, training=True,
                            generator=generator, return_ctx=True)
    loss = task.loss(out, batch, params=model.params)
    loss = loss + model.layer_losses(fw)
    return loss + regularization * model.weight_l2()


def fit(model: Trainable, train: Predictor, valid: Optional[Predictor] = None,
        test: Optional[Predictor] = None, patience: int = 100,
        learning_rate: float = 0.01, regularization: float = 5.0e-4,
        verbose: bool = False, epochs: int = 2000,
        degradation: Callable[[int], float] = lambda epoch: 1,
        batches: int = 1, optimizer=None, seed: Optional[int] = None,
        block_epochs: int = 1, callbacks=(),
        checkpoint_dir: Optional[str] = None, checkpoint_every: int = 25,
        resume: bool = False, mesh=None, spmm: Optional[str] = None,
        spmm_impl: Optional[str] = None, init_params=None,
        remat: bool = False) -> Dict:
    """Train ``model`` in place; leaves the best-validation parameters in
    ``model.params`` and returns a history dict (``train_loss``,
    ``valid_loss``, ``epochs_run``, ``best_epoch``).

    ``spmm_impl`` selects the SpMM implementation for this call only, scoped
    around each step and each validation forward.  ``init_params``
    (``{name: array}``) replaces the fresh ``reset(seed)``.  ``optimizer``
    is any object with :class:`KerasAdam`'s ``init``/``update``.  The step's
    CPU generator is seeded from ``seed + 1`` (or ``measures.next_seed()``)
    and the step index, so a run's edge-dropout masks are the same on every
    device."""
    _unported(mesh=mesh is not None, spmm=spmm is not None,
              checkpoint_dir=checkpoint_dir is not None, resume=resume,
              remat=remat, block_epochs=block_epochs > 1)
    del checkpoint_every  # only meaningful with checkpoint_dir
    if spmm_impl is not None and spmm_impl not in _IMPL_NAMES:
        raise ValueError(f"spmm_impl must be one of {_IMPL_NAMES}, "
                         f"got {spmm_impl!r}")
    if init_params is not None:
        from ..interop import params_from_jax
        params_from_jax(init_params, model)
    else:
        model.reset(seed)
    params = model.params
    tx = optimizer if optimizer is not None else keras_adam(learning_rate)
    if valid is None:
        valid = train  # trainable.py:58-59
    trainable = model.trainable_mask()
    names = [k for k in params if trainable.get(k, True)]
    opt_state = tx.init({k: p.detach() for k, p in params.items()})
    rng_seed = measures.next_seed() if seed is None else seed + 1

    def snapshot():
        return {k: p.detach().clone() for k, p in params.items()}

    min_loss = float("inf")
    best_params = snapshot()
    patience_remaining = patience
    history = {"train_loss": [], "valid_loss": [], "epochs_run": 0,
               "best_epoch": -1}
    stop = False
    epoch = 0
    while epoch < epochs and not stop:
        epoch_loss = 0.0
        deg = torch.tensor(float(degradation(epoch)), dtype=torch.float32)
        for b in range(batches):
            train.refresh()
            batch = train.batch()
            generator = torch.Generator().manual_seed(
                _fold_in(rng_seed, epoch * batches + b))
            with _impl_scope(spmm_impl):
                loss = _total_loss(model, train, batch, regularization,
                                   generator)
                found = dict(zip(names, torch.autograd.grad(
                    loss, [params[k] for k in names], allow_unused=True)))
            # gradient of loss * degradation(epoch) (trainable.py:78); frozen
            # parameters get zero gradients, so their moments stay zero
            grads = {}
            for k, p in params.items():
                g = found.get(k)
                grads[k] = torch.zeros_like(p) if g is None \
                    else g * deg.to(g.device)
            updates, opt_state = tx.update(grads, opt_state)
            with torch.no_grad():
                for k, u in updates.items():
                    params[k].add_(u)
            epoch_loss += loss.item()

        # clean validation forward (dropout off), trainable.py:83
        with torch.no_grad(), _impl_scope(spmm_impl):
            acts = model.forward(model.features, training=False)
        valid.refresh()
        valid_loss = float(valid.loss(acts, valid.batch(), params=params))

        patience_remaining -= 1
        improved = valid_loss < min_loss  # strict improvement (:96)
        if verbose and improved:
            train_acc = float(train.evaluate(acts, train.batch(), params))
            valid_acc = float(valid.evaluate(acts, valid.batch(), params))
            test_acc = float("nan") if test is None else float(
                test.evaluate(acts, test.batch(), params))
            print(f"\rEpoch {epoch}  patience {patience_remaining}  "
                  f"Train loss {epoch_loss:.3f} Validation loss "
                  f"{valid_loss:.3f}  Train {train_acc:.3f} Validation "
                  f"{valid_acc:.3f}  Test {test_acc:.3f}", end="")
        if improved:
            min_loss = valid_loss
            best_params = snapshot()
            patience_remaining = patience
            history["best_epoch"] = epoch
        history["train_loss"].append(epoch_loss)
        history["valid_loss"].append(valid_loss)
        for cb in callbacks:
            stop = bool(cb(epoch=epoch, params=params, valid_loss=valid_loss,
                           best_loss=min_loss,
                           patience_remaining=patience_remaining)) or stop
        if patience_remaining == 0:
            break
        epoch += 1

    with torch.no_grad():  # restore the best snapshot (trainable.py:101-102)
        for k, p in params.items():
            p.copy_(best_params[k])
    model._act_cache = None
    history["epochs_run"] = epoch + 1
    if verbose:
        print("\r")
    return history
