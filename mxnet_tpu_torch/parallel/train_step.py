"""The single-device training step.

Counterpart of the ``mesh=None`` subset of ``mxnet_tpu/parallel/train_step.py``:
one call is forward, backward and the optimizer update of every trainable
parameter. Where the JAX step is one compiled program with donated
buffers, this one runs eagerly and updates the module's parameters and
the optimizer state in place. The step count lives on the card and the
bias-corrected learning rate is computed there from it, so a step issues
its work without waiting for the card: the returned loss is a 0-d device
tensor, and reading it is the caller's sync.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["TrainStep"]


class TrainStep:
    """Forward, backward and update of ``net`` on its own device.

    Parameters
    ----------
    net : torch.nn.Module whose parameters are named as the JAX package's
        (``word_embed.weight``, ...); it stays on its device.
    loss_fn : callable(out, *labels) -> loss tensor; its f32 mean is the
        training loss.
    optimizer : an ``mxnet_tpu_torch.optimizer.Optimizer``.
    n_model_inputs : how many leading batch entries go to ``net``.
    mesh, layout, amp : not ported yet; anything but None raises.

    Parameters with ``requires_grad=False`` are frozen (the JAX
    ``grad_req='null'``). Per-parameter ``lr_mult``/``wd_mult`` resolve as
    in the JAX step: the ``optimizer.param_dict`` entry, else the parameter's
    own attribute, times the optimizer's name-keyed dicts.
    """

    def __init__(self, net, loss_fn, optimizer, mesh=None,
                 n_model_inputs: int = 1, amp=None, layout=None):
        if mesh is not None or layout is not None:
            raise MXNetError("TrainStep(mesh=/layout=) is not ported yet: the "
                             "port's TrainStep runs on one device")
        if amp is not None:
            raise MXNetError("TrainStep(amp=...) is not ported yet: the "
                             "port's TrainStep trains in the parameters' "
                             "dtype")
        self.net = net
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.n_model_inputs = n_model_inputs
        self._plist = sorted(net.named_parameters())
        if not self._plist:
            raise MXNetError("TrainStep: the net has no parameters")
        self.device = self._plist[0][1].device
        self._train = [(i, name, p) for i, (name, p) in enumerate(self._plist)
                       if p.requires_grad]
        self.opt_state = {name: optimizer.create_state(i, p.detach())
                          for i, name, p in self._train}
        self.step_count = torch.zeros((), dtype=torch.int32,
                                      device=self.device)
        self._hyper_key = None
        self._lr_wd = None

    def _resolve_mults(self):
        """Per-name lr/wd multipliers, as ``_resolve_mults`` of the JAX step."""
        opt = self.optimizer
        lr_mult, wd_mult = {}, {}
        for _, name, p in self._train:
            src = opt.param_dict.get(name, p)
            lr_mult[name] = float(getattr(src, "lr_mult", 1.0)) * \
                float(opt.lr_mult.get(name, 1.0))
            wd_mult[name] = float(getattr(src, "wd_mult", 1.0)) * \
                float(opt.wd_mult.get(name, 1.0))
        return lr_mult, wd_mult

    def _rates(self):
        """(N,) f32 device tensors of lr·lr_mult and wd·wd_mult, products
        taken in f32 as the JAX step takes them. Rebuilt (one small copy to
        the card) only when a rate or a multiplier changed."""
        lr_mult, wd_mult = self._resolve_mults()
        lr, wd = self.optimizer.learning_rate, self.optimizer.wd
        key = (lr, wd, tuple(lr_mult.values()), tuple(wd_mult.values()))
        if key != self._hyper_key:
            names = [name for _, name, _ in self._train]
            lrs = np.float32(lr) * np.array([lr_mult[n] for n in names],
                                            np.float32)
            wds = np.float32(wd) * np.array([wd_mult[n] for n in names],
                                            np.float32)
            self._lr_wd = (torch.from_numpy(lrs).to(self.device),
                           torch.from_numpy(wds).to(self.device))
            self._hyper_key = key
        return self._lr_wd

    def _as_batch(self, b):
        if torch.is_tensor(b):
            if b.device != self.device:
                raise MXNetError(f"batch tensor on {b.device}, the net on "
                                 f"{self.device}")
            return b
        return torch.as_tensor(np.asarray(b), device=self.device)

    def __call__(self, *batch):
        """Run one step. ``batch = (x, label, ...)`` as tensors on the net's
        device or numpy arrays. Returns the loss as a 0-d f32 device
        tensor."""
        batch = tuple(self._as_batch(b) for b in batch)
        n = self.n_model_inputs
        was_training = self.net.training
        self.net.train()
        try:
            with torch.enable_grad():
                out = self.net(*batch[:n])
                loss = self.loss_fn(out, *batch[n:]).float().mean()
                params = [p for _, _, p in self._train]
                grads = torch.autograd.grad(loss, params, allow_unused=True)
        finally:
            self.net.train(was_training)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        lr, wd = self._rates()
        with torch.no_grad():
            self.step_count += 1
            self.optimizer.update_raw_multi(
                [p.detach() for p in params], grads,
                [self.opt_state[name] for _, name, _ in self._train],
                lr, wd, self.step_count)
        self.optimizer.num_update += 1
        return loss.detach()

    def sync(self):
        """Kept for the API: the parameters are updated in place, so the net
        already holds them."""
