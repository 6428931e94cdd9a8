"""The port's training checkpoints (``mxnet_tpu_torch.checkpoint``,
``resilience/integrity.py``, ``TrainStep.save``/``restore``) against the
JAX package's, mirroring tests/test_checkpoint.py and the checkpoint cases
of tests/test_resilience.py: resume bit-identically; a checkpoint written
by either package restores in the other (the next two losses agree to
1e-5 and the manifests' digests are equal); crash mid-save, corrupt
arrays, a corrupt manifest, meta-less and orphaned directories and
retention behave as in JAX; a ``net.cast("bfloat16")`` checkpoint
round-trips across the packages bit for bit."""
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import checkpoint as jckpt
from mxnet_tpu import config as jconfig
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.parallel import TrainStep as JTrainStep
from mxnet_tpu.resilience import integrity as jint
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import checkpoint as tckpt
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import observability as tobs
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.checkpoint import (CheckpointCorruptError,
                                        latest_checkpoint, load_train_state,
                                        save_train_state)
from mxnet_tpu_torch.contrib.amp import Policy
from mxnet_tpu_torch.parallel import TrainStep
from mxnet_tpu_torch.resilience import InjectedCrash, RetryError, faults
from mxnet_tpu_torch.resilience import integrity as tint
from mxnet_tpu_torch.resilience import retry

from test_torch_train_loop import _batches, _loss, _mlp, _same, _state

TOL = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture(autouse=True)
def _isolated_faults():
    faults.reset()
    retry.clear_log()
    yield
    faults.reset()
    retry.clear_log()


def _w(v):
    return {"w": torch.as_tensor(np.asarray(v, np.float32))}


def _tstep(amp=None, dtype=None, opt=None):
    return TrainStep(_mlp(dtype=dtype), _loss,
                     opt or topt.Adam(learning_rate=1e-2), amp=amp)


def _jstep(dtype=None):
    net = _mlp("jax", dtype=dtype)
    return JTrainStep(net, _loss, jopt.Adam(learning_rate=1e-2), mesh=None,
                      amp=None)


def _digests(path):
    with open(os.path.join(path, "manifest.json")) as f:
        mf = json.load(f)
    return [(mf["arrays"][str(i)]["sha256"], mf["arrays"][str(i)]["dtype"],
             mf["arrays"][str(i)]["shape"])
            for i in range(len(mf["arrays"]))]


# -- resume ------------------------------------------------------------------
def test_trainstep_save_restore_resumes_identically(tmp_path):
    d = str(tmp_path / "ckpt")
    data = _batches(5)
    ts = _tstep()
    for x, y in data[:3]:
        ts(x, y)
    ts.save(d)
    expected = torch.stack([ts(x, y) for x, y in data[3:]])
    ts2 = _tstep()
    ts2(*data[0])  # a program exists before the restore
    programs, recaptures = ts2.compiled_programs, ts2.recaptures
    assert ts2.restore(d)
    assert ts2.optimizer.num_update == 3 and int(ts2.step_count) == 3
    resumed = torch.stack([ts2(x, y) for x, y in data[3:]])
    assert torch.equal(expected, resumed)
    # restore wrote into the existing storage: nothing was captured anew
    assert ts2.recaptures == recaptures
    assert ts2.compiled_programs == programs
    assert not ts2.restore(str(tmp_path / "empty"))


def test_float16_carry_and_applied_step_resume(tmp_path):
    """meta.json carries the applied count and the loss-scale carry: a
    resumed float16 run continues bit-identically, skips included."""
    d = str(tmp_path / "ckpt")
    pol = Policy("float16", loss_scale=2.0 ** 40)
    data = _batches(6)
    ts = _tstep(amp=pol)
    ts.run(iter(data[:2]), steps=2, window=2)
    ts.save(d)
    with open(os.path.join(latest_checkpoint(d), "meta.json")) as f:
        meta = json.load(f)
    assert meta["step"] == 2 and meta["applied_step"] == int(ts.step_count)
    assert meta["amp_state"]["skipped"] == ts.amp_skipped_steps >= 1
    want = ts.run(iter(data[2:]), steps=4, window=2)
    ts2 = _tstep(amp=pol)
    assert ts2.restore(d)
    assert ts2.loss_scale == meta["amp_state"]["scale"]
    got = ts2.run(iter(data[2:]), steps=4, window=2)
    assert torch.equal(want, got)
    assert ts2.amp_skipped_steps == ts.amp_skipped_steps
    assert int(ts2.step_count) == int(ts.step_count)


def test_bfloat16_net_resume_keeps_the_masters(tmp_path):
    """A ``net.cast("bfloat16")`` net trains through f32 masters whose low
    bits the bf16 weights do not hold: ``masters.npz`` (listed in the
    manifest) carries them, so the resumed run equals the uninterrupted
    one bit for bit (losses, bf16 weights, masters, moments, step count).
    The JAX package restores the same checkpoint from its own arrays."""
    d = str(tmp_path / "ckpt")
    data = [tuple(torch.from_numpy(a).bfloat16() for a in b)
            for b in _batches(6)]
    ts = _tstep(dtype="bfloat16")
    ts.run(iter(data[:2]), steps=2, window=2)
    path = ts.save(d)
    assert any(not torch.equal(m, m.bfloat16().float())
               for m in ts._master.values())
    with open(os.path.join(path, "manifest.json")) as f:
        assert "masters.npz" in json.load(f)["files"]
    want = ts.run(iter(data[2:]), steps=4, window=2)
    ts2 = _tstep(dtype="bfloat16")
    ts2.run(iter(data[:2]), steps=2, window=2)  # a program before restore
    recaptures = ts2.recaptures
    assert ts2.restore(d)
    got = ts2.run(iter(data[2:]), steps=4, window=2)
    assert torch.equal(want, got)
    _same(_state(ts2), _state(ts))
    assert ts2.recaptures == recaptures
    jts = _jstep(dtype="bfloat16")
    assert jts.restore(d) and jts.optimizer.num_update == 2
    # a masters file that does not match its manifest entry: not a
    # candidate for latest_checkpoint, and load_masters refuses it
    with open(os.path.join(path, "masters.npz"), "r+b") as f:
        f.seek(-8, os.SEEK_END)
        f.write(b"\0" * 8)
    assert latest_checkpoint(d) is None
    with pytest.raises(CheckpointCorruptError):
        tckpt.load_masters(path)


def test_latest_checkpoint_selection(tmp_path):
    d = str(tmp_path / "c")
    save_train_state(d, 5, _w(np.ones(2)), {})
    save_train_state(d, 12, _w(np.ones(2)), {})
    assert latest_checkpoint(d).endswith("ckpt-12")
    assert latest_checkpoint(str(tmp_path / "missing")) is None


# -- across the packages -------------------------------------------------------
def test_jax_checkpoint_restores_in_the_port(tmp_path):
    d, d2 = str(tmp_path / "jax"), str(tmp_path / "port")
    data = _batches(5)
    jts = _jstep()
    for x, y in data[:3]:
        jts(jmx.nd.array(x), jmx.nd.array(y))
    jts.save(d)
    jnext = [float(np.asarray(jts(jmx.nd.array(x), jmx.nd.array(y))))
             for x, y in data[3:]]
    ts = _tstep()
    assert ts.restore(d)
    assert ts.optimizer.num_update == 3 and int(ts.step_count) == 3
    ts.save(d2)  # the same state, written by the port
    assert _digests(latest_checkpoint(d2)) == _digests(latest_checkpoint(d))
    tnext = [float(ts(x, y)) for x, y in data[3:]]
    np.testing.assert_allclose(tnext, jnext, **TOL)


def test_port_checkpoint_restores_in_jax(tmp_path):
    d, d2 = str(tmp_path / "port"), str(tmp_path / "jax")
    data = _batches(5)
    ts = _tstep()
    for x, y in data[:3]:
        ts(x, y)
    ts.save(d)
    tnext = [float(ts(x, y)) for x, y in data[3:]]
    jts = _jstep()
    assert jts.restore(d)  # verifies the port's manifest itself
    assert jts.optimizer.num_update == 3 and int(jts.step_count) == 3
    jts.save(d2)
    assert _digests(latest_checkpoint(d2)) == _digests(latest_checkpoint(d))
    assert open(os.path.join(latest_checkpoint(d), "treedef.txt")).read() \
        == open(os.path.join(latest_checkpoint(d2), "treedef.txt")).read()
    jnext = [float(np.asarray(jts(jmx.nd.array(x), jmx.nd.array(y))))
             for x, y in data[3:]]
    np.testing.assert_allclose(tnext, jnext, **TOL)


def test_bfloat16_net_checkpoint_round_trips_across_packages(tmp_path):
    """bf16 parameters travel as raw 2-byte records with the manifest dtype
    "bfloat16": JAX -> port -> JAX and port -> JAX -> port keep every
    byte."""
    j1, t1, j2 = (str(tmp_path / n) for n in ("j1", "t1", "j2"))
    data = _batches(2)
    jts = _jstep(dtype="bfloat16")
    for x, y in data:
        jts(jmx.nd.array(x, dtype="bfloat16"),
            jmx.nd.array(y, dtype="bfloat16"))
    jts.save(j1)
    ts = _tstep(dtype="bfloat16")
    assert ts.restore(j1)
    assert all(p.dtype == torch.bfloat16 for _, p in ts._plist)
    ts.save(t1)
    assert _digests(latest_checkpoint(t1)) == _digests(latest_checkpoint(j1))
    assert {dt for _, dt, _ in _digests(latest_checkpoint(t1))} == \
        {"bfloat16", "float32"}
    jts2 = _jstep(dtype="bfloat16")
    assert jts2.restore(t1)
    jts2.save(j2)
    assert _digests(latest_checkpoint(j2)) == _digests(latest_checkpoint(t1))
    # the masters were cast again from the restored bf16 parameters
    for name, p in ts._plist:
        assert torch.equal(ts._master[name], p.detach().float())


def test_array_digest_matches_jax():
    import ml_dtypes

    rs = np.random.RandomState(0)
    a = rs.randn(3, 5).astype(np.float32)
    t = torch.from_numpy(a)
    assert tint.array_digest(t) == jint.array_digest(a)
    assert tint.array_digest(t.T) == jint.array_digest(a.T)
    b = t.bfloat16()
    jb = a.astype(ml_dtypes.bfloat16)
    assert tint.array_digest(b) == jint.array_digest(jb)
    assert tint.dtype_name(b) == str(jb.dtype) == "bfloat16"
    i = rs.randint(0, 9, (4,)).astype(np.int32)
    assert tint.array_digest(torch.from_numpy(i)) == jint.array_digest(i)


def test_save_train_state_files_match_jax(tmp_path):
    """The same tree written by both packages: the same treedef text and
    the same manifest arrays, and each package loads the other's."""
    params = {"b": np.arange(3, dtype=np.float32),
              "a": np.ones((2, 2), np.float32)}
    opt = {"b": (np.zeros(3, np.float32), np.ones(3, np.float32)),
           "a": None}
    tp = save_train_state(str(tmp_path / "t"), 4,
                          {k: torch.from_numpy(v) for k, v in params.items()},
                          {"b": tuple(torch.from_numpy(v) for v in opt["b"]),
                           "a": None})
    jp = jckpt.save_train_state(str(tmp_path / "j"), 4, params, opt)
    assert _digests(tp) == _digests(jp)
    assert open(os.path.join(tp, "treedef.txt")).read() == \
        open(os.path.join(jp, "treedef.txt")).read()
    jl = jckpt.load_train_state(tp, like=(params, opt))
    tl = load_train_state(jp, like=(params, opt))
    assert jl[2] == tl[2] == 4
    np.testing.assert_array_equal(tl[0]["a"].numpy(), jl[0]["a"])
    np.testing.assert_array_equal(tl[1]["b"][1].numpy(), jl[1]["b"][1])
    assert tl[1]["a"] is None


# -- crash safety and validation (tests/test_resilience.py) -------------------
def test_crash_during_save_resumes_from_previous_valid(tmp_path):
    d = str(tmp_path / "ckpt")
    data = _batches(3)
    ts = _tstep()
    ts(*data[0])
    ts(*data[1])
    ts.save(d)  # ckpt-2, valid
    at_2 = [p.detach().clone() for _, p in ts._plist]
    ts(*data[2])
    faults.arm("ckpt.save", on=1, crash=True)
    with pytest.raises(InjectedCrash):
        ts.save(d)  # dies after arrays.npz, before manifest/commit
    assert os.path.isdir(os.path.join(d, "ckpt-3.tmp"))
    assert not os.path.exists(os.path.join(d, "ckpt-3"))
    assert latest_checkpoint(d).endswith("ckpt-2")
    ts2 = _tstep()
    assert ts2.restore(d)
    assert ts2.optimizer.num_update == 2
    for (_, p), want in zip(ts2._plist, at_2):
        assert torch.equal(p.detach(), want)


def test_transient_save_and_load_faults_are_retried(tmp_path):
    tconfig.set("retry_base_delay", 0.001)
    try:
        faults.load_spec("ckpt.save:every=2;ckpt.load:every=2;seed=5")
        d = str(tmp_path / "c")
        for s in range(1, 4):
            save_train_state(d, s, _w(np.full(2, s)), {})
        params, _o, step = load_train_state(latest_checkpoint(d),
                                            like=(_w(np.ones(2)), {}))
    finally:
        tconfig._values.pop("retry_base_delay", None)
    assert step == 3
    assert torch.equal(params["w"], torch.full((2,), 3.0))
    assert any(not r["ok"] for r in retry.attempt_log("ckpt.save"))


def test_corrupt_arrays_skipped_and_load_rejects(tmp_path):
    d = str(tmp_path / "c")
    save_train_state(d, 1, _w(np.arange(4.0)), {})
    p2 = save_train_state(d, 2, _w(np.ones(4)), {})
    blob = bytearray(open(os.path.join(p2, "arrays.npz"), "rb").read())
    blob[len(blob) // 2] ^= 0xFF  # same size, different bytes
    with open(os.path.join(p2, "arrays.npz"), "wb") as f:
        f.write(bytes(blob))
    assert latest_checkpoint(d).endswith("ckpt-1")
    like = (_w(np.ones(4)), {})
    with pytest.raises((CheckpointCorruptError, RetryError)):
        load_train_state(p2, like=like)
    params, _opt, step = load_train_state(latest_checkpoint(d), like=like)
    assert step == 1
    assert torch.equal(params["w"], torch.arange(4.0))


def test_manifest_catches_rewritten_arrays(tmp_path):
    d = str(tmp_path / "c")
    p = save_train_state(d, 7, _w(np.ones(3)), {})
    np.savez(os.path.join(p, "arrays.npz"), **{"0": np.zeros(3, np.float32)})
    assert latest_checkpoint(d) is None  # file sha mismatch -> invalid
    with pytest.raises(CheckpointCorruptError):
        load_train_state(p, like=(_w(np.ones(3)), {}))


def test_latest_checkpoint_skips_meta_less_partial_dirs(tmp_path):
    d = str(tmp_path / "c")
    save_train_state(d, 3, _w(np.ones(2)), {})
    os.makedirs(os.path.join(d, "ckpt-9"))  # partial write: no meta.json
    assert latest_checkpoint(d).endswith("ckpt-3")
    assert latest_checkpoint(d, validate=False).endswith("ckpt-9")


def test_corrupt_manifest_json_skipped_not_raised(tmp_path):
    d = str(tmp_path / "c")
    save_train_state(d, 1, _w(np.ones(2)), {})
    p2 = save_train_state(d, 2, _w(np.ones(2)), {})
    with open(os.path.join(p2, "manifest.json"), "w") as f:
        f.write('{"format": "npz", "files"')  # torn mid-write
    assert latest_checkpoint(d).endswith("ckpt-1")
    with pytest.raises(CheckpointCorruptError):
        load_train_state(p2, like=(_w(np.ones(2)), {}))


def test_orphaned_stale_checkpoint_recovered(tmp_path):
    d = str(tmp_path / "c")
    p = save_train_state(d, 5, _w(np.ones(2)), {})
    os.replace(p, p + ".stale")  # died after the aside-rename
    assert latest_checkpoint(d).endswith("ckpt-5")
    assert os.path.isdir(p) and not os.path.exists(p + ".stale")


def test_retention_sweep_keeps_last_n(tmp_path):
    d = str(tmp_path / "c")
    for s in range(1, 6):
        save_train_state(d, s, _w(np.full(2, s)), {})
    os.makedirs(os.path.join(d, "ckpt-0.tmp"))  # stale interrupted stage
    save_train_state(d, 6, _w(np.ones(2)), {}, keep_last=3)
    assert sorted(os.listdir(d)) == ["ckpt-4", "ckpt-5", "ckpt-6"]
    tconfig.set("ckpt_keep_last", 1)
    try:
        save_train_state(d, 7, _w(np.ones(2)), {})
    finally:
        tconfig._values.pop("ckpt_keep_last", None)
    assert sorted(os.listdir(d)) == ["ckpt-7"]


def test_template_mismatch_and_unported_formats_raise(tmp_path):
    d = str(tmp_path / "c")
    p = save_train_state(d, 1, _w(np.ones(2)), {})
    with pytest.raises(MXNetError, match="do not fit"):
        load_train_state(p, like=(_w(np.ones(3)), {}))
    with pytest.raises(MXNetError, match="npz-shards"):
        save_train_state(d, 2, _w(np.ones(2)), {}, sharded=True)
    tconfig.set("ckpt_sharded", True)
    try:
        with pytest.raises(MXNetError, match="npz-shards"):
            save_train_state(d, 2, _w(np.ones(2)), {})
    finally:
        tconfig._values.pop("ckpt_sharded", None)
    jp = jckpt.save_train_state(str(tmp_path / "j"), 1,
                                {"w": np.ones(2, np.float32)}, {},
                                sharded=True)
    with pytest.raises(MXNetError, match="npz-shards"):
        load_train_state(jp, like=(_w(np.ones(2)), {}))


@pytest.mark.parametrize("name", ["ckpt_keep_last", "ckpt_sharded"])
def test_checkpoint_knobs_match_jax(name, monkeypatch):
    jt, jd, jenv, _ = jconfig._KNOBS[name]
    tt, td, tenv, _ = tconfig._KNOBS[name]
    assert (tt, td, tenv) == (jt, jd, jenv)
    monkeypatch.setenv(tenv[0], {bool: "1", int: "7"}[tt])
    assert tconfig.get(name) == jconfig.get(name)


def test_checkpoint_telemetry(tmp_path):
    saves = tobs.counter("ckpt_saves_total").total()
    loads = tobs.counter("ckpt_loads_total").total()
    nbytes = tobs.counter("ckpt_bytes_total").value(op="save")
    p = save_train_state(str(tmp_path / "c"), 1, _w(np.ones(8)), {})
    load_train_state(p, like=(_w(np.ones(8)), {}))
    assert tobs.counter("ckpt_saves_total").total() == saves + 1
    assert tobs.counter("ckpt_loads_total").total() == loads + 1
    assert tobs.counter("ckpt_bytes_total").value(op="save") > nbytes
    assert tobs.histogram("ckpt_save_seconds").total_count() >= 1
    assert tobs.histogram("ckpt_verify_seconds").total_count() >= 1


def test_plain_module_keys_by_structural_names(tmp_path):
    """A plain torch module (no Gluon names) writes its sorted structural
    names: the recorded divergence from the JAX step's Parameter names."""
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    ts = TrainStep(net, _loss, topt.SGD(learning_rate=0.1))
    assert ts._ckpt_names == {n: n for n, _ in net.named_parameters()}
    ts(np.ones((2, 3), np.float32), np.zeros((2, 2), np.float32))
    path = ts.save(str(tmp_path / "m"))
    tree = open(os.path.join(path, "treedef.txt")).read()
    assert tree == ("PyTreeDef({'opt_state': {'0.bias': None, '0.weight': "
                    "None, '1.bias': None, '1.weight': None}, 'params': "
                    "{'0.bias': *, '0.weight': *, '1.bias': *, '1.weight': "
                    "*}})")
