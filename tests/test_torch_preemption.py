"""Graceful preemption in the port (``resilience/preemption.py``,
``TrainStep.install_preemption``, ``gluon.Trainer.install_preemption``),
mirroring the preemption cases of tests/test_resilience.py: a request (or
SIGTERM) checkpoints once at the next step or window boundary and raises
``Preempted`` (``SystemExit(0)``); the checkpoint resumes the run."""
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu.resilience import preemption as jpre
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.checkpoint import latest_checkpoint
from mxnet_tpu_torch.parallel import TrainStep
from mxnet_tpu_torch.resilience import Preempted, PreemptionGuard

from test_torch_train_loop import _batches, _loss, _mlp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ts():
    return TrainStep(_mlp(), _loss, topt.Adam(learning_rate=1e-2))


def test_guard_matches_jax():
    """The same surface and semantics as the JAX guard."""
    for mod in (jpre, tmx.resilience.preemption):
        g = mod.PreemptionGuard(signals=())
        assert not g.requested
        g.request(15)
        assert g.requested and g.signum == 15 and g.wait(0)
        g.clear()
        assert not g.requested and g.signum is None
        e = mod.Preempted(2)
        assert isinstance(e, SystemExit) and e.code == 0 and e.signum == 2
    assert [n for n in dir(jpre.PreemptionGuard) if not n.startswith("__")] \
        == [n for n in dir(PreemptionGuard) if not n.startswith("__")]


def test_signal_handler_installs_and_restores():
    prev = signal.getsignal(signal.SIGTERM)
    g = PreemptionGuard().install()
    try:
        assert signal.getsignal(signal.SIGTERM) == g._on_signal
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.wait(5) and g.signum == signal.SIGTERM
    finally:
        g.uninstall()
    assert signal.getsignal(signal.SIGTERM) == prev


def test_trainstep_preemption_checkpoints_at_step_boundary(tmp_path):
    d = str(tmp_path / "ckpt")
    data = _batches(4)
    ts = _ts()
    guard = ts.install_preemption(d)
    try:
        ts(*data[0])
        guard.request()
        with pytest.raises(Preempted) as ei:
            ts(*data[1])  # completes the step, checkpoints, then unwinds
        assert ei.value.code == 0
        assert latest_checkpoint(d).endswith("ckpt-2")
    finally:
        guard.uninstall()
        guard.clear()
    # the checkpoint resumes the run bit-identically
    want = torch.stack([ts(x, y) for x, y in data[2:]])
    ts2 = _ts()
    assert ts2.restore(d)
    assert torch.equal(torch.stack([ts2(x, y) for x, y in data[2:]]), want)


def test_trainstep_preemption_at_window_boundary(tmp_path):
    """A request while window 1 is being fed: the window completes, one
    checkpoint lands at its boundary, Preempted is raised and the second
    window never runs."""
    d = str(tmp_path / "ckpt")
    ts = _ts()
    guard = ts.install_preemption(d, guard=PreemptionGuard(signals=()))
    data = _batches(8)

    def source():
        for i, b in enumerate(data):
            if i == 2:
                guard.request()
            yield b

    with pytest.raises(Preempted):
        ts.run(source(), steps=8, window=4)
    assert ts._window_dispatches == 1 and ts.optimizer.num_update == 4
    assert [os.path.basename(p) for p in os.listdir(d)] == ["ckpt-4"]
    assert latest_checkpoint(d).endswith("ckpt-4")
    assert ts._prefetcher is None  # the run closed its own prefetcher


def test_exit_on_preempt_false_saves_once(tmp_path):
    d = str(tmp_path / "ckpt")
    ts = _ts()
    guard = ts.install_preemption(d, guard=PreemptionGuard(signals=()),
                                  exit_on_preempt=False)
    guard.request()
    for x, y in _batches(3):
        ts(x, y)
    assert os.listdir(d) == ["ckpt-1"]  # one-shot: not re-saved each step


def _imperative_step(net, trainer, x, y):
    with tmx.cpu():
        xa, ya = tmx.nd.array(x), tmx.nd.array(y)
        with tmx.autograd.record():
            loss = ((net(xa) - ya) ** 2).mean()
        loss.backward()
    trainer.step(4)


def test_trainer_preemption_runs_save_fn_then_exits():
    net = _mlp()
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
    saved = []
    guard = trainer.install_preemption(lambda: saved.append(True),
                                       guard=PreemptionGuard(signals=()))
    guard.request()
    with pytest.raises(Preempted):
        _imperative_step(net, trainer, *_batches(1)[0])
    assert saved == [True]  # the checkpoint action ran before the exit


def test_trainer_run_preemption_writes_states_back():
    """A request during Trainer.run: as in JAX the trainer checks its guard
    when the run returns, after the states and counts were written back,
    runs its save_fn once and exits."""
    net = _mlp()
    trainer = tmx.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-2})
    ts_guard = PreemptionGuard(signals=())
    saved = []
    trainer.install_preemption(lambda: saved.append(True), guard=ts_guard)
    data = _batches(4)

    def source():
        for i, b in enumerate(data):
            if i == 1:
                ts_guard.request()
            yield b

    with pytest.raises(Preempted):
        trainer.run(net, _loss, source(), steps=4, window=2)
    ts = trainer._fused[1]
    assert ts.optimizer.num_update == 4
    assert trainer.optimizer._index_update_count == {i: 4 for i in range(4)}
    assert all(trainer._states_created)
    assert saved == [True]


def test_sigterm_subprocess_checkpoints_and_exits_zero(tmp_path):
    """The real-signal contract end to end: SIGTERM -> checkpoint at the
    next step boundary -> exit code 0, a valid checkpoint on disk."""
    d = str(tmp_path / "ckpt")
    script = textwrap.dedent("""
        import sys, time
        import numpy as np
        import torch
        from mxnet_tpu_torch import optimizer
        from mxnet_tpu_torch.parallel import TrainStep

        net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.ReLU(),
                                  torch.nn.Linear(4, 2))
        ts = TrainStep(net, lambda o, y: ((o - y) ** 2).mean(),
                       optimizer.SGD(learning_rate=0.1))
        ts.install_preemption(sys.argv[1])
        x, y = np.ones((2, 3), np.float32), np.zeros((2, 2), np.float32)
        ts(x, y)
        print("READY", flush=True)
        while True:
            ts(x, y)
            time.sleep(0.02)
    """)
    proc = subprocess.Popen([sys.executable, "-c", script, d], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True,
                            env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        assert "READY" in proc.stdout.readline()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 0, proc.stdout.read()
    path = latest_checkpoint(d)
    assert path is not None  # a committed, manifest-valid checkpoint
    assert int(os.path.basename(path).split("-")[1]) >= 2
    np.testing.assert_equal(sorted(os.listdir(path)),
                            ["arrays.npz", "manifest.json", "meta.json",
                             "treedef.txt"])
