"""Estimator (reference: ``python/mxnet/gluon/contrib/estimator/estimator.py``,
the late-1.x high-level fit loop with event handlers).

Counterpart of ``mxnet_tpu/gluon/contrib/estimator.py``: the six event
bases, every handler and ``Estimator.fit``/``evaluate``, over the port's
``autograd``, ``gluon.Trainer``, ``metric`` and ``observability``. The
``train_loss`` gauge is set (one host read of the loss a batch) only under
telemetry; without it the loop reads nothing back from the card.
"""
from __future__ import annotations

import copy
import logging
import time

from ... import autograd
from ... import metric as metric_mod
from ... import observability as _obs
from ..trainer import Trainer

__all__ = ["Estimator", "TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd",
           "BatchBegin", "BatchEnd", "CheckpointHandler", "EarlyStoppingHandler",
           "LoggingHandler", "MetricHandler", "GradientUpdateHandler",
           "ValidationHandler", "StoppingHandler", "PreemptionHandler"]


class TrainBegin:
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd:
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin:
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd:
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin:
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd:
    def batch_end(self, estimator, *args, **kwargs):
        pass


class LoggingHandler(TrainBegin, EpochEnd, BatchEnd):
    """Console + event-log progress reporting.

    Loss and throughput come from the observability metrics registry when
    the loop is instrumented (telemetry on): the ``train_loss`` gauge the
    fit loop maintains and sample/step-time counter deltas from
    ``Trainer.step`` (``observability.throughput_delta``): the same series
    the JSONL log and the Prometheus export see, so every surface reports
    identical numbers. The eval-metric values
    computed by ``MetricHandler`` are always included."""

    def __init__(self, log_interval=50):
        self.log_interval = log_interval
        self._n = 0
        self._last_reg = None

    def _registry_stats(self):
        """(samples_per_sec, loss) from registry deltas; Nones without data."""
        g = _obs.REGISTRY.get("train_loss")
        loss = g.value() if g is not None else None
        speed, self._last_reg = _obs.throughput_delta(self._last_reg)
        return speed, loss

    def batch_end(self, estimator, batch=None, **kwargs):
        self._n += 1
        if self.log_interval and self._n % self.log_interval == 0:
            vals = " ".join(f"{m.get()[0]}={m.get()[1]:.5f}"
                            for m in estimator.train_metrics)
            speed, loss = self._registry_stats()
            if loss is not None:
                vals += f" loss={loss:.5f}"
            if speed is not None:
                vals += f" throughput={speed:.2f} samples/sec"
            logging.info("Batch[%s] %s", batch, vals)
            # eval metrics ride in a nested dict: their names are
            # user-controlled and must never collide with envelope keys
            _obs.emit("log", scope="batch", batch=batch, loss=loss,
                      samples_per_sec=speed,
                      metrics={m.get()[0]: m.get()[1]
                               for m in estimator.train_metrics})

    def epoch_end(self, estimator, epoch=None, **kwargs):
        vals = " ".join(f"{m.get()[0]}={m.get()[1]:.5f}"
                        for m in estimator.train_metrics)
        live_val = [m for m in estimator.val_metrics if getattr(m, "num_inst", 0)]
        if live_val:
            vals += " " + " ".join(f"val_{m.get()[0]}={m.get()[1]:.5f}"
                                   for m in live_val)
        _speed, loss = self._registry_stats()
        if loss is not None:
            vals += f" loss={loss:.5f}"
        logging.info("Epoch[%s] %s", epoch, vals)
        _obs.emit("log", scope="epoch", epoch=epoch, loss=loss,
                  metrics={m.get()[0]: m.get()[1]
                           for m in estimator.train_metrics})


class CheckpointHandler(EpochEnd):
    def __init__(self, model_dir, model_prefix="model", save_best=False,
                 monitor=None, mode="max"):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.save_best = save_best
        self.monitor = monitor  # default: first val metric, else first train
        self.mode = mode
        self.best = None

    def _monitored_value(self, estimator):
        # val metrics only count once validation actually ran (no val_data ->
        # never-updated metrics report NaN, which would freeze save_best)
        live_val = [m for m in estimator.val_metrics if getattr(m, "num_inst", 0)]
        metrics = live_val or estimator.train_metrics
        for m in metrics:
            name, val = m.get()
            if self.monitor is None or name == self.monitor:
                return val
        return None

    def epoch_end(self, estimator, epoch=None, **kwargs):
        import os

        os.makedirs(self.model_dir, exist_ok=True)
        estimator.net.save_parameters(
            f"{self.model_dir}/{self.model_prefix}-{epoch:04d}.params")
        if self.save_best:
            val = self._monitored_value(estimator)
            better = val is not None and (self.best is None or (
                val > self.best if self.mode == "max" else val < self.best))
            if better:
                self.best = val
                estimator.net.save_parameters(
                    f"{self.model_dir}/{self.model_prefix}-best.params")


class EarlyStoppingHandler(EpochEnd):
    def __init__(self, monitor, patience=3, mode="min"):
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.best = None
        self.waited = 0
        self.stop_training = False

    def epoch_end(self, estimator, epoch=None, **kwargs):
        for m in estimator.train_metrics:
            name, val = m.get()
            if name != self.monitor:
                continue
            better = self.best is None or (
                val < self.best if self.mode == "min" else val > self.best)
            if better:
                self.best, self.waited = val, 0
            else:
                self.waited += 1
                if self.waited >= self.patience:
                    self.stop_training = True


class MetricHandler(EpochBegin, BatchEnd):
    """Resets train metrics at epoch start and updates them per batch
    (reference: ``event_handler.py MetricHandler`` — metric bookkeeping is a
    handler, not a hard-coded loop step, so users can re-order/replace it)."""

    def __init__(self, metrics=None, priority=-1000):
        self.metrics = metrics
        self.priority = priority  # after GradientUpdate (-2000), before user handlers (0)

    def _metrics(self, estimator):
        return self.metrics if self.metrics is not None else estimator.train_metrics

    def epoch_begin(self, estimator, **kwargs):
        for m in self._metrics(estimator):
            m.reset()

    def batch_end(self, estimator, label=None, pred=None, **kwargs):
        if label is not None and pred is not None:
            for m in self._metrics(estimator):
                m.update(label, pred)


class GradientUpdateHandler(BatchEnd):
    """Applies the optimizer step at batch end (reference:
    ``GradientUpdateHandler`` — keeping the update a handler lets users
    change its cadence, e.g. gradient accumulation)."""

    def __init__(self, priority=-2000):
        self.priority = priority

    def batch_end(self, estimator, batch_size=1, **kwargs):
        estimator.trainer.step(batch_size)


class ValidationHandler(TrainBegin, EpochEnd, BatchEnd):
    """Periodic validation (reference: ``ValidationHandler`` with
    ``epoch_period``/``batch_period``). Runs AFTER the gradient update
    (priority 0 > GradientUpdateHandler's -2000)."""

    def __init__(self, val_data, epoch_period=1, batch_period=None,
                 batches=None):
        self.val_data = val_data
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.batches = batches
        self._n_batches = 0

    def train_begin(self, estimator, **kwargs):
        self._n_batches = 0  # reusable across fit() calls

    def batch_end(self, estimator, **kwargs):
        self._n_batches += 1
        if self.batch_period and self._n_batches % self.batch_period == 0:
            estimator.evaluate(self.val_data, batches=self.batches)

    def epoch_end(self, estimator, epoch=None, **kwargs):
        if self.epoch_period and (epoch is None
                                  or (epoch + 1) % self.epoch_period == 0):
            estimator.evaluate(self.val_data, batches=self.batches)


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop after ``max_epoch`` epochs or ``max_batch`` total batches
    (reference: ``StoppingHandler``)."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.stop_training = False
        self._batches = 0

    def train_begin(self, estimator, **kwargs):
        self.stop_training = False  # reusable across fit() calls
        self._batches = 0

    def batch_end(self, estimator, **kwargs):
        self._batches += 1
        if self.max_batch is not None and self._batches >= self.max_batch:
            self.stop_training = True

    def epoch_end(self, estimator, epoch=None, **kwargs):
        if self.max_epoch is not None and epoch is not None \
                and epoch + 1 >= self.max_epoch:
            self.stop_training = True


class PreemptionHandler(TrainBegin, BatchEnd, TrainEnd):
    """Graceful preemption for the fit loop (``resilience.PreemptionGuard``):
    SIGTERM/SIGINT flips a flag; at the next batch
    boundary the net's parameters (and the trainer's optimizer states) are
    saved and the loop stops — fit() returns normally so the caller's own
    teardown runs before the process exits.

    Priority -1500 places the save AFTER the gradient update (-2000) of the
    same batch, so the preemption checkpoint includes the final step.
    """

    def __init__(self, model_dir, model_prefix="model", guard=None,
                 priority=-1500):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.priority = priority
        self.stop_training = False
        from ...resilience import PreemptionGuard

        self.guard = guard or PreemptionGuard()

    def train_begin(self, estimator, **kwargs):
        self.stop_training = False
        self.guard.clear()  # a leftover request from the previous fit()
        # would otherwise stop this run after one batch
        self.guard.install()

    def batch_end(self, estimator, **kwargs):
        import os

        if not self.guard.requested:
            return
        os.makedirs(self.model_dir, exist_ok=True)
        prefix = os.path.join(self.model_dir, self.model_prefix)
        estimator.net.save_parameters(f"{prefix}-preempt.params")
        estimator.trainer.save_states(f"{prefix}-preempt.states")
        logging.info("preemption checkpoint saved to %s-preempt.*", prefix)
        self.stop_training = True

    def train_end(self, estimator, **kwargs):
        self.guard.uninstall()


class Estimator:
    def __init__(self, net, loss, train_metrics=None, trainer=None, context=None,
                 val_metrics=None):
        self.net = net
        self.loss = loss
        specs = (train_metrics if isinstance(train_metrics, (list, tuple))
                 else [train_metrics or "acc"])
        self.train_metrics = [metric_mod.create(m) for m in specs]
        if val_metrics is not None:
            self.val_metrics = [metric_mod.create(m) for m in val_metrics]
        else:  # cloned instances so val accumulation never aliases train,
            # preserving configuration (top_k, feval, ...) of each metric
            self.val_metrics = []
            for m in self.train_metrics:
                c = copy.deepcopy(m)
                c.reset()
                self.val_metrics.append(c)
        self.trainer = trainer or Trainer(net.collect_params(), "adam",
                                          {"learning_rate": 1e-3})

    def evaluate(self, val_data, batches=None):
        """Run the validation loop, updating ``self.val_metrics``."""
        for m in self.val_metrics:
            m.reset()
        for i, (data, label) in enumerate(val_data):
            if batches is not None and i >= batches:
                break
            out = self.net(data)
            for m in self.val_metrics:
                m.update(label, out)
        return {m.get()[0]: m.get()[1] for m in self.val_metrics}

    def fit(self, train_data, val_data=None, epochs=1, event_handlers=None,
            batches=None):
        handlers = list(event_handlers or [LoggingHandler()])
        # default handler composition (reference: fit() always prepends the
        # metric + gradient-update handlers unless the caller supplied their
        # own instances) — the train loop itself only fires events
        if not any(isinstance(h, MetricHandler) for h in handlers):
            handlers.insert(0, MetricHandler())
        if not any(isinstance(h, GradientUpdateHandler) for h in handlers):
            handlers.insert(0, GradientUpdateHandler())
        # event dispatch order = priority then list order (reference:
        # event_handler priorities — GradientUpdateHandler's -2000 puts the
        # optimizer step before metric/validation handlers regardless of
        # where the caller placed it in the list)
        handlers.sort(key=lambda h: getattr(h, "priority", 0))

        def stop():
            return any(getattr(h, "stop_training", False) for h in handlers)

        for h in handlers:
            if isinstance(h, TrainBegin):
                h.train_begin(self)
        for epoch in range(epochs):
            for h in handlers:
                if isinstance(h, EpochBegin):
                    h.epoch_begin(self, epoch=epoch)
            for i, (data, label) in enumerate(train_data):
                if batches is not None and i >= batches:
                    break
                for h in handlers:
                    if isinstance(h, BatchBegin):
                        h.batch_begin(self, batch=i)
                with autograd.record():
                    out = self.net(data)
                    loss = self.loss(out, label)
                loss.backward()
                if _obs.enabled():
                    # the registry's train_loss gauge is what LoggingHandler
                    # and the exporters report; one scalar sync per batch,
                    # only when telemetry is armed
                    _obs.gauge("train_loss").set(
                        float(loss.mean().asnumpy()))
                for h in handlers:
                    if isinstance(h, BatchEnd):
                        h.batch_end(self, batch=i, label=label, pred=out,
                                    loss=loss, batch_size=data.shape[0])
                if stop():
                    break
            if val_data is not None and not any(
                    isinstance(h, ValidationHandler) for h in handlers):
                self.evaluate(val_data, batches=batches)
            for h in handlers:
                if isinstance(h, EpochEnd):
                    h.epoch_end(self, epoch=epoch)
            if stop():
                break
        for h in handlers:
            if isinstance(h, TrainEnd):
                h.train_end(self)
        return self
