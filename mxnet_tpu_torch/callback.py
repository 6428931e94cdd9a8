"""Training callbacks (reference: ``python/mxnet/callback.py``).

Counterpart of ``mxnet_tpu/callback.py``: ``Speedometer``,
``do_checkpoint``, ``LogValidationMetricsCallback``, ``ProgressBar`` and
``log_train_metric``, with the same arguments and log lines.
"""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint", "LogValidationMetricsCallback",
           "ProgressBar", "log_train_metric"]


class Speedometer:
    """Logs samples/sec every ``frequent`` batches (the classic training log).

    When the observability registry has step telemetry (a ``Trainer``/
    ``TrainStep`` running with telemetry enabled), throughput is read from
    the registry's sample/step-time series (``observability.
    throughput_delta``), so the console line, the JSONL event log and the
    Prometheus export report the same number; the reference-style wall
    clock is the fallback."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0
        self.last_count = 0
        self._last_reg = None

    def _registry_speed(self):
        """samples/sec from registry deltas since the last log; None when
        no new step telemetry arrived (telemetry off or loop uninstrumented)."""
        from .observability import throughput_delta

        speed, self._last_reg = throughput_delta(self._last_reg)
        return speed

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                speed = self._registry_speed() or \
                    self.frequent * self.batch_size / (time.time() - self.tic)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s"
                    logging.info(msg, param.epoch, count, speed,
                                 "\t".join(f"{n}={v:f}" for n, v in name_value))
                else:
                    logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                                 param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


def do_checkpoint(prefix, period=1):
    """Epoch-end callback: every ``period`` epochs write
    ``{prefix}-{epoch:04d}.params`` (the ``arg:`` names, a file either
    package loads) and, when given a symbol, ``{prefix}-symbol.json``."""

    def _callback(epoch, sym, arg_params, aux_params):
        if (epoch + 1) % period == 0:
            from .serialization import save_ndarrays

            if sym is not None:
                sym.save(f"{prefix}-symbol.json")
            save_ndarrays(f"{prefix}-{epoch + 1:04d}.params",
                          {f"arg:{k}": getattr(v, "_data", v)
                           for k, v in arg_params.items()})
            logging.info("Saved checkpoint to \"%s-%04d.params\"", prefix,
                         epoch + 1)

    return _callback


class LogValidationMetricsCallback:
    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name, value)


class ProgressBar:
    """Text progress bar per batch (reference callback.ProgressBar)."""

    def __init__(self, total, length=80):
        self.total = max(int(total), 1)
        self.length = int(length)

    def __call__(self, param):
        count = getattr(param, "nbatch", 0)
        filled = int(round(self.length * min(count, self.total) / self.total))
        bar = "=" * filled + "-" * (self.length - filled)
        print(f"\r[{bar}] {count}/{self.total}", end="", flush=True)
        if count >= self.total:
            print()


def log_train_metric(period, auto_reset=False):
    """Log the evaluation metric every ``period`` batches (reference
    callback.log_train_metric)."""

    def _callback(param):
        if param.nbatch % max(int(period), 1) == 0 and \
                param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value() \
                if hasattr(param.eval_metric, "get_name_value") \
                else [param.eval_metric.get()]
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback
