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

``fit(block_epochs=N)`` with static tasks, or a sampled training task that
stacks its batches, takes the fused path of the JAX package
(``_fit_fused``): blocks of N epochs whose state (parameters, optimizer
moments, the best parameters, the least loss, the patience left and a
``stopped`` flag) stays on the device and is read back once a block.  On a
card one epoch is captured in a CUDA graph and replayed; on the CPU the
same epoch runs eagerly.

``fit(checkpoint_dir=, checkpoint_every=, resume=)`` writes and restores
the early-stopping state (``utils/checkpoint.py``) on both paths;
``fit(remat=True)`` recomputes each layer in the backward
(``Network.forward``).

``fit(mesh=, spmm=)`` trains on every rank of a mesh (``parallel/``):
every SpMM of the step and of the evaluation goes through the mesh's
executor (``spmm`` None or ``"gspmd"``, ``"halo"``, ``"ring"``), scoped
around each call; under gspmd each rank holds its column block of the
hidden weights and of their moments (``parallel.dist.place_state``), the
whole parameters put back at the end.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from .. import measures
from ..nn.core import DrawTape, Network
from ..ops.spmm import _IMPL_NAMES, spmm_executor, spmm_impl as _impl_scope
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

    def step_size(self, count: int) -> float:
        """``alpha`` of update ``count`` (from 1), computed in float32."""
        t = torch.tensor(float(count), dtype=torch.float32)
        f32 = lambda a: torch.tensor(a, dtype=torch.float32)
        return float(f32(self.learning_rate) * torch.sqrt(
            1.0 - torch.pow(f32(self.b2), t))
            / (1.0 - torch.pow(f32(self.b1), t)))

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state,
               step_size: Optional[torch.Tensor] = None):
        """``(updates, new_state)``: the updates are added to the
        parameters.  ``step_size``, a 0-d float32 tensor (the fused
        trainer's entry of a table of :meth:`step_size`), replaces the step
        size computed on the host from the count."""
        b1, b2 = self.b1, self.b2
        count = state["count"] + 1
        m = {k: b1 * state["m"][k] + (1.0 - b1) * g for k, g in grads.items()}
        v = {k: b2 * state["v"][k] + (1.0 - b2) * torch.square(g)
             for k, g in grads.items()}
        alpha = self.step_size(count) if step_size is None else step_size
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


_EXECUTORS = (None, "gspmd", "halo", "ring")


@contextlib.contextmanager
def _scope(spmm_impl: Optional[str], executor=None):
    """The SpMM implementation, and with a mesh its executor, in force for
    one step or evaluation."""
    with _impl_scope(spmm_impl):
        if executor is None:
            yield
        else:
            with spmm_executor(executor):
                yield


def _total_loss(model: Trainable, task: Predictor, batch, regularization,
                generator, remat=False, graph=None):
    out, fw = model.forward(model.features, training=True,
                            generator=generator, return_ctx=True, remat=remat,
                            graph=graph)
    loss = task.loss(out, batch, params=model.params)
    loss = loss + model.layer_losses(fw)
    return loss + regularization * model.weight_l2()


def _train_step(model: Trainable, task: Predictor, batch, regularization,
                generator, remat, names, tx, opt_state, deg, graph=None):
    """One step of the host loop: the training forward (over ``graph`` in
    place of the model's own, where given) and loss, the gradients of
    ``loss * deg`` (frozen parameters get zeros, so their moments stay zero)
    and the optimizer's update of ``model.params`` in place; returns the new
    optimizer state and the loss."""
    params = model.params
    loss = _total_loss(model, task, batch, regularization, generator, remat,
                       graph)
    found = dict(zip(names, torch.autograd.grad(
        loss, [params[k] for k in names], allow_unused=True)))
    # gradient of loss * degradation(epoch) (trainable.py:78)
    grads = {}
    for k, p in params.items():
        g = found.get(k)
        grads[k] = torch.zeros_like(p) if g is None else g * deg.to(g.device)
    updates, opt_state = tx.update(grads, opt_state)
    with torch.no_grad():
        for k, u in updates.items():
            params[k].add_(u)
    return opt_state, loss


def _like(template, restored):
    """``restored`` (nested dicts of numpy arrays, from a checkpoint) in the
    form of ``template``: tensors on the template's device and dtype,
    Python numbers as numbers."""
    if isinstance(template, dict):
        return {k: _like(v, restored[k]) for k, v in template.items()}
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(np.asarray(restored), dtype=template.dtype,
                               device=template.device)
    return type(template)(np.asarray(restored).item())


class _RunState:
    """The early-stopping state of a run that a checkpoint holds: the
    optimizer state, the best parameters, the least validation loss, the
    patience left, the history, the first epoch to run and the seed of the
    run's draws (the JAX package's ``fit``,
    ``gnntf_tpu/train/trainer.py:359-391``)."""

    def __init__(self, model, tx, patience, rng_seed):
        params = model.params
        self.shards = model.shards  # a checkpoint holds whole arrays
        self.opt_state = tx.init({k: p.detach() for k, p in params.items()})
        self.best = {k: p.detach().clone() for k, p in params.items()}
        self.min_loss = float("inf")
        self.patience_remaining = patience
        self.history = {"train_loss": [], "valid_loss": [], "epochs_run": 0,
                        "best_epoch": -1}
        self.start_epoch = 0
        self.rng_seed = rng_seed

    @torch.no_grad()
    def restore(self, model, directory) -> None:
        """Continue from the latest checkpoint in ``directory``, if any."""
        from ..utils.checkpoint import restore_checkpoint
        restored = restore_checkpoint(directory)
        if restored is None:
            return
        step, state = restored
        if self.shards is not None:
            state = dict(state, **{k: self.shards.blocks(state[k]) for k in (
                "params", "opt_state", "best_params")})
        params = model.params
        for k, p in params.items():
            p.copy_(torch.as_tensor(state["params"][k]))
        if state["opt_state"] is not None:
            self.opt_state = _like(self.opt_state, state["opt_state"])
        if state["best_params"] is not None:
            self.best = _like(self.best, state["best_params"])
        meta = state["meta"]
        self.start_epoch = int(meta.get("epoch", step)) + 1
        self.min_loss = float(meta.get("min_loss", self.min_loss))
        self.patience_remaining = int(meta.get("patience_remaining",
                                               self.patience_remaining))
        self.history["best_epoch"] = int(meta.get("best_epoch", -1))
        # the seed of the draws, so that a resumed seed=None run draws what
        # the uninterrupted one would
        self.rng_seed = int(meta.get("rng_seed", self.rng_seed))
        model._act_cache = None

    def save(self, directory, epoch, params) -> None:
        from ..utils.checkpoint import save_checkpoint
        whole = (lambda tree: tree) if self.shards is None \
            else self.shards.wholes
        save_checkpoint(
            directory, epoch, params=whole(dict(params)),
            opt_state=whole(self.opt_state), best_params=whole(self.best),
            meta={"epoch": epoch, "min_loss": self.min_loss,
                  "patience_remaining": self.patience_remaining,
                  "best_epoch": self.history["best_epoch"],
                  "rng_seed": self.rng_seed})


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
    device.

    ``remat=True`` runs each layer of the training forward under
    ``torch.utils.checkpoint`` (``Network.forward``).  With
    ``checkpoint_dir`` the early-stopping state is written every
    ``checkpoint_every`` epochs and at the end (``utils/checkpoint.py``);
    ``resume=True`` continues from the latest checkpoint there.  The
    sampler of a sampled task is not saved, as in the JAX package.

    ``block_epochs > 1`` with one batch, ``verbose`` off, a static
    validation task and a static or stackable (``supports_stacking``)
    training task takes the fused path (:func:`_fit_fused`), as in the JAX
    package; its history holds every epoch of the last block and
    ``epochs_run`` counts them.  A sampled task stacks only without a mesh.

    ``mesh`` (``parallel.make_mesh``, inside an initialized process group)
    runs every SpMM through the executor that ``spmm`` names: None or
    ``"gspmd"`` the edge-sharded partials, ``"halo"`` or ``"ring"`` the
    row-block exchanges; ``spmm`` is ignored without a mesh.  Every rank
    trains the same model from the same seed; under gspmd on a mesh with a
    ``feat`` axis each holds its column block of the hidden weights and of
    their moments (``parallel.dist.place_state``), and the callbacks, the
    checkpoints and ``model.params`` after the run see whole arrays."""
    if spmm not in _EXECUTORS:
        raise ValueError(f"spmm executor must be None, 'gspmd', 'halo' or "
                         f"'ring', got {spmm!r}")
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
    executor = None
    if mesh is not None:
        from ..parallel.dist import executor_for, place_state
        place_state(model, mesh, shard=spmm in (None, "gspmd"))
        executor = executor_for(mesh, spmm)
    run = _RunState(model, tx, patience,
                    measures.next_seed() if seed is None else seed + 1)
    if checkpoint_dir and resume:
        run.restore(model, checkpoint_dir)
    history = run.history
    train_stackable = (not train.static and mesh is None
                       and getattr(train, "supports_stacking", False))
    if (block_epochs > 1 and batches == 1 and not verbose
            and (train.static or train_stackable) and valid.static):
        return _fit_fused(
            model, train, valid, tx, names, run, patience=patience,
            epochs=epochs,
            degradation=degradation, block_epochs=block_epochs,
            regularization=regularization, callbacks=callbacks,
            spmm_impl=spmm_impl, remat=remat, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, executor=executor)
    stop = False
    epoch = run.start_epoch
    while epoch < epochs and not stop:
        epoch_loss = 0.0
        deg = torch.tensor(float(degradation(epoch)), dtype=torch.float32)
        for b in range(batches):
            train.refresh()
            batch = train.batch()
            generator = torch.Generator().manual_seed(
                _fold_in(run.rng_seed, epoch * batches + b))
            with _scope(spmm_impl, executor):
                run.opt_state, loss = _train_step(
                    model, train, batch, regularization, generator, remat,
                    names, tx, run.opt_state, deg)
            epoch_loss += loss.item()

        # clean validation forward (dropout off), trainable.py:83
        with torch.no_grad(), _scope(spmm_impl, executor):
            acts = model.forward(model.features, training=False)
            valid.refresh()
            valid_loss = float(valid.loss(acts, valid.batch(), params=params))

        run.patience_remaining -= 1
        improved = valid_loss < run.min_loss  # strict improvement (:96)
        if verbose and improved:
            train_acc = float(train.evaluate(acts, train.batch(), params))
            valid_acc = float(valid.evaluate(acts, valid.batch(), params))
            test_acc = float("nan") if test is None else float(
                test.evaluate(acts, test.batch(), params))
            print(f"\rEpoch {epoch}  patience {run.patience_remaining}  "
                  f"Train loss {epoch_loss:.3f} Validation loss "
                  f"{valid_loss:.3f}  Train {train_acc:.3f} Validation "
                  f"{valid_acc:.3f}  Test {test_acc:.3f}", end="")
        if improved:
            run.min_loss = valid_loss
            run.best = {k: p.detach().clone() for k, p in params.items()}
            run.patience_remaining = patience
            history["best_epoch"] = epoch
        history["train_loss"].append(epoch_loss)
        history["valid_loss"].append(valid_loss)
        seen = _whole(model) if callbacks else None
        for cb in callbacks:
            stop = bool(cb(epoch=epoch, params=seen, valid_loss=valid_loss,
                           best_loss=run.min_loss,
                           patience_remaining=run.patience_remaining)) or stop
        if checkpoint_dir and checkpoint_every and \
                (epoch + 1) % checkpoint_every == 0:
            run.save(checkpoint_dir, epoch, params)
        if run.patience_remaining == 0:
            break
        epoch += 1

    if checkpoint_dir:
        run.save(checkpoint_dir, min(epoch, epochs - 1), params)
    _restore_best(model, run.best)
    history["epochs_run"] = epoch + 1
    if verbose:
        print("\r")
    return history


def _whole(model):
    """The parameters as the callbacks see them: whole arrays."""
    if model.shards is None:
        return model.params
    return model.shards.wholes(dict(model.params))


def _restore_best(model, best) -> None:
    """Put the best snapshot in place (trainable.py:101-102) and, on a mesh
    that held column blocks, the whole parameters back."""
    with torch.no_grad():
        for k, p in model.params.items():
            p.copy_(best[k])
    if model.shards is not None:
        from ..parallel.dist import unshard
        unshard(model)
    model._act_cache = None


def _on(batch, device):
    """A task's batch with its tensors on ``device``."""
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    if isinstance(batch, (tuple, list)):
        return type(batch)(_on(b, device) for b in batch)
    return batch


def _tree_leaves(tree, path=()):
    """``(path, leaf)`` of each leaf of a tree of dicts."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_leaves(v, path + (str(k),))
    else:
        yield path, tree


def _tree_map(fn, tree, other):
    """``fn(leaf, other_leaf)`` over the leaves of two trees of dicts, in
    the form of ``tree``."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def _check_capturable(state, device) -> None:
    """Raise ``ValueError`` naming the first leaf of an optimizer's state
    that a CUDA graph cannot carry: one that is not a tensor on
    ``device``'s kind of device."""
    for path, leaf in _tree_leaves(state):
        if not isinstance(leaf, torch.Tensor):
            found = type(leaf).__name__
        elif leaf.device.type != device.type:
            found = f"a tensor on {leaf.device}"
        else:
            continue
        raise ValueError(
            f"fit(block_epochs > 1) on a card replays the optimizer's update "
            f"in a CUDA graph, which needs every leaf of its state to be a "
            f"tensor on {device}; leaf {'/'.join(path)!r} is {found} (train "
            f"with block_epochs=1, or keep it as a tensor)")


class _FusedEpoch:
    """One epoch of the fused path (the body of the JAX package's scan,
    ``gnntf_tpu/train/trainer.py:516-544``) over tensors updated in place,
    so that a card can capture it once in a CUDA graph and replay it.

    The step (the training forward, whose draws come from :attr:`tape`;
    the loss; the gradients of ``loss * degradation``; the optimizer
    update) and the clean validation forward and loss; the parameters and
    the optimizer state stay as they are once ``stopped`` is set (each
    tensor of the state written in place, any other leaf, on the host
    only, rebound); the best parameters, the least validation loss, the
    patience left, the updates applied and ``stopped`` are tensors.  Epoch
    ``step`` of the block reads its degradation from :attr:`deg`, its step
    size from :attr:`alpha` (for :class:`KerasAdam`), its salts from
    :attr:`salt_table` and its eager masks' uniforms from row ``step`` of
    the tape's tables, writes its train loss, validation loss and
    improvement to column ``step`` of :attr:`out`, and advances ``step``.
    A stacked (sampled) training task reads its batch from the fixed
    tensors of :attr:`train_batch`, which :meth:`feed` fills with the
    epoch's slice of the block's stack."""

    def __init__(self, model, train, valid, tx, names, run: _RunState, *,
                 stacked, regularization, patience, block_epochs, spmm_impl,
                 remat, executor=None):
        device = model.device
        self.model, self.tx, self.names = model, tx, names
        self.train_task, self.valid_task = train, valid
        self.train_batch = None  # a stacked task's, made by the first feed
        if not stacked:
            train.refresh()
            self.train_batch = _on(train.batch(), device)
        valid.refresh()
        self.valid_batch = _on(valid.batch(), device)
        self.regularization, self.patience = regularization, patience
        self.block_epochs = block_epochs
        self.spmm_impl, self.remat = spmm_impl, remat
        self.executor = executor
        self.adam = isinstance(tx, KerasAdam)
        self.state = run.opt_state
        self.best = {k: p.clone() for k, p in run.best.items()}
        f32 = dict(dtype=torch.float32, device=device)
        i64 = dict(dtype=torch.int64, device=device)
        self.min_loss = torch.full((), run.min_loss, **f32)
        self.pat = torch.full((), run.patience_remaining, **i64)
        self.stopped = torch.zeros((), dtype=torch.bool, device=device)
        self.count = torch.full((), run.opt_state.get("count", 0)
                                if self.adam else 0, **i64)
        self.step = torch.zeros(1, **i64)
        self.deg = torch.zeros(block_epochs, **f32)
        self.alpha = torch.zeros(block_epochs, **f32)
        self.out = torch.zeros(3, block_epochs, **f32)
        self.tape = DrawTape()
        self.salt_table = None  # (block_epochs, K, 2), once recorded

    def stop_recording(self) -> None:
        """End the tape's recording: its salt slots, the block's salt table
        and its tables of uniforms, their row the epoch's ``step``."""
        device = self.model.device
        self.tape.stop(device, rows=self.block_epochs, row=self.step)
        self.salt_table = torch.zeros(
            (self.block_epochs,) + tuple(self.tape.salts.shape),
            dtype=torch.int64, device=device)

    def feed(self, stack, i: int) -> None:
        """Copy epoch ``i`` of a stacked task's block (``stack_batches``)
        into :attr:`train_batch`."""
        if self.train_batch is None:
            self.train_batch = tuple(None if t is None else t[i].clone()
                                     for t in stack)
            return
        for fixed, t in zip(self.train_batch, stack):
            if t is not None:
                fixed.copy_(t[i])

    def __call__(self) -> None:
        model, params, i = self.model, self.model.params, self.step
        stopped = self.stopped
        if not self.tape.recording and len(self.tape.salts):
            self.tape.salts.copy_(self.salt_table.index_select(0, i)[0])
        with _scope(self.spmm_impl, self.executor):
            loss = _total_loss(model, self.train_task, self.train_batch,
                               self.regularization, self.tape, self.remat)
            found = dict(zip(self.names, torch.autograd.grad(
                loss, [params[k] for k in self.names], allow_unused=True)))
        deg = self.deg.index_select(0, i).view(())
        grads = {k: torch.zeros_like(p) if found.get(k) is None
                 else found[k] * deg for k, p in params.items()}
        with torch.no_grad():
            if self.adam:  # the step size from the host-computed table
                updates, new = self.tx.update(
                    grads, self.state,
                    step_size=self.alpha.index_select(0, i).view(()))
                new["count"] = self.state["count"]  # counted in self.count
                self.count.add_((~stopped).to(torch.int64))
            else:
                updates, new = self.tx.update(grads, self.state)
            self.state = _tree_map(functools.partial(_gated, stopped),
                                   self.state, new)
            for k, u in updates.items():
                params[k].copy_(torch.where(stopped, params[k],
                                            params[k] + u))
            with _scope(self.spmm_impl, self.executor):
                acts = model.forward(model.features, training=False)
            vloss = self.valid_task.loss(acts, self.valid_batch,
                                         params=params)
            improved = (vloss < self.min_loss) & ~stopped
            pat = torch.where(stopped, self.pat, self.pat - 1)
            for k, p in params.items():
                self.best[k].copy_(torch.where(improved, p, self.best[k]))
            self.min_loss.copy_(torch.where(improved, vloss, self.min_loss))
            self.pat.copy_(torch.where(improved, self.patience, pat))
            stopped.copy_(stopped | (self.pat <= 0))
            self.out.index_copy_(1, i, torch.stack(
                [loss.detach(), vloss, improved.to(torch.float32)])[:, None])
            i.add_(1)

    def opt_state(self):
        """The optimizer state as the host loop keeps it."""
        if not self.adam:
            return self.state
        return dict(self.state, count=int(self.count))


def _gated(stopped, old, new):
    """A leaf of the optimizer's state after an epoch: a tensor keeps its
    buffer, written with ``new`` unless ``stopped``; another leaf (the CPU
    only: ``fit`` refuses it on a card) is ``new`` unless ``stopped``."""
    if isinstance(old, torch.Tensor):
        return old.copy_(torch.where(stopped, old, new))
    if new is old:
        return old
    return old if bool(stopped) else new


def _capture(run: _FusedEpoch, stream) -> "torch.cuda.CUDAGraph":
    """``run`` captured in a CUDA graph on ``stream`` (which ran the
    recording epoch, so every memo is built), each of the tape's generators
    and twins registered so that a replay takes its seed."""
    graph = torch.cuda.CUDAGraph()
    for generator in [*run.tape.generators, *run.tape.twins.values()]:
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph, stream=stream):
        run()
    return graph


def _fit_fused(model: Trainable, train: Predictor, valid: Predictor, tx,
               names, state: _RunState, *, patience, epochs, degradation,
               block_epochs,
               regularization, callbacks, spmm_impl, remat, checkpoint_dir,
               checkpoint_every, executor=None) -> Dict:
    """The fused multi-epoch path (the JAX package's ``_fit_fused``,
    ``gnntf_tpu/train/trainer.py:477-603``): blocks of ``min(block_epochs,
    epochs - epoch)`` epochs of :class:`_FusedEpoch`, read back once a
    block; the callbacks then see each epoch of the block with the running
    best loss and ``patience_remaining=-1``; with ``checkpoint_dir`` and
    ``checkpoint_every`` each block ends with a checkpoint; a block that
    ends stopped ends the run, ``epochs_run`` is the epochs run, and the
    best parameters are restored.

    A sampled task (``supports_stacking``) draws the block's batches with
    ``stack_batches`` before the block, uploaded once, and each epoch is
    fed its slice (:meth:`_FusedEpoch.feed`, one device-to-device copy).

    The run's first epoch records the draws (:class:`DrawTape`) from its
    generator, as the host loop draws them; every later epoch is fed the
    record rerun on its own generator, so the numbers equal the host
    loop's: the salts and the eager masks' uniforms of a block go to device
    tables once a block, each generator is seeded before its epoch.  On a
    card the first epoch runs on a side stream, which builds every memo,
    and the next is captured there in a CUDA graph, replayed once an epoch:
    a capture that fails raises.  :class:`KerasAdam` reads its step size
    from a host-computed table; any other optimizer runs its own update in
    the capture, every leaf of its state a tensor on the card (else
    ``ValueError``).  Under remat a recompute draws from the tape's twin
    generators, also registered with the graph."""
    device = model.device
    cuda = device.type == "cuda"
    stacked = not train.static
    run = _FusedEpoch(model, train, valid, tx, names, state, stacked=stacked,
                      regularization=regularization,
                      patience=patience,
                      block_epochs=block_epochs, spmm_impl=spmm_impl,
                      remat=remat, executor=executor)
    if cuda and not run.adam:
        _check_capturable(run.state, device)
    epoch_generator = lambda e: torch.Generator().manual_seed(
        _fold_in(state.rng_seed, e))
    history = state.history
    count0 = int(run.count)
    graph, best_before = None, state.min_loss
    epoch = first_epoch = state.start_epoch
    while epoch < epochs:
        n = min(block_epochs, epochs - epoch)
        span = range(epoch, epoch + n)
        run.deg[:n].copy_(torch.tensor([float(degradation(e)) for e in span],
                                       dtype=torch.float32))
        if run.adam:
            run.alpha[:n].copy_(torch.tensor(
                [tx.step_size(count0 + e - first_epoch + 1) for e in span],
                dtype=torch.float32))
        stack = train.stack_batches(n, device=device) if stacked else None
        run.step.zero_()
        first = 0
        if epoch == first_epoch:
            if stacked:
                run.feed(stack, 0)
            run.tape.record(epoch_generator(epoch))
            if cuda:
                stream = torch.cuda.Stream(device)
                stream.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(stream):
                    run()
                torch.cuda.current_stream(device).wait_stream(stream)
            else:
                run()
            run.stop_recording()
            if cuda and epochs - first_epoch > 1:
                graph = _capture(run, stream)
            first = 1
        draws = [run.tape.draw(epoch_generator(e)) for e in span[first:]]
        if draws and len(run.tape.salts):
            run.salt_table[first:n].copy_(torch.stack([d[0] for d in draws]))
        if draws:
            run.tape.fill(first, [d[2] for d in draws])
        for i, (_, seeds, _) in enumerate(draws, start=first):
            if stacked:
                run.feed(stack, i)
            run.tape.feed(seeds)
            if graph is not None:
                graph.replay()
            else:
                run()
        # the block's numbers in one read
        back = torch.cat([run.out[:, :n].reshape(-1), run.min_loss.view(1),
                          run.stopped.view(1).to(torch.float32),
                          run.pat.view(1).to(torch.float32)]).cpu()
        losses, vlosses = back[:n].numpy(), back[n:2 * n].numpy()
        history["train_loss"].extend(losses.tolist())
        history["valid_loss"].extend(vlosses.tolist())
        for i in np.flatnonzero(back[2 * n:3 * n].numpy()):
            history["best_epoch"] = epoch + int(i)
        if callbacks:
            running_best = np.minimum.accumulate(
                np.minimum(vlosses, best_before))
            params = _whole(model)
            for cb in callbacks:
                for i in range(n):
                    cb(epoch=epoch + i, params=params,
                       valid_loss=float(vlosses[i]),
                       best_loss=float(running_best[i]),
                       patience_remaining=-1)
        best_before = float(back[3 * n])
        epoch += n
        if checkpoint_dir and checkpoint_every:
            state.opt_state, state.best = run.opt_state(), run.best
            state.min_loss = best_before
            state.patience_remaining = int(back[3 * n + 2])
            state.save(checkpoint_dir, epoch - 1, model.params)
        if back[3 * n + 1]:
            break

    _restore_best(model, run.best)
    history["epochs_run"] = epoch
    return history
