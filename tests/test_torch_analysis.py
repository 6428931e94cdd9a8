"""The port's program auditor (``mxnet_tpu_torch/analysis``) against the JAX
package's ``analysis/*``, on the CPU:

  - fingerprints, their diffs and the recompile guard give the JAX events
    on the same inputs; a TrainStep's shape and dtype recompiles carry
    JAX's cause and detail;
  - ``TrainStep.audit`` (step and window) and ``GenerationEngine.audit``
    (dense and paged decode, a prefill bucket, ``"cow"``, the draft and
    verify programs) update their whole carry in place; the carries are
    as long as JAX's, and the paged decode's ``params`` / ``kv_pages``
    bytes equal JAX's memory report;
  - an audit changes no parameter, random stream or token;
  - each kernel wrapper records itself as one ``custom_call`` op (and no
    plain version), priced at the products of the function it computes;
  - the liveness and schedule models (the per-dtype peaks, the knobs);
  - the CUDA-event windows of a capture on the card, beside its step
    rows (a synthetic report);
  - ``op_class``'s table, and ``calibrate`` on JAX's synthetic schedules;
  - the hazard linter's rules on torch spellings (JAX's cases but JH006)
    and the port's package lint-clean.
"""
import json
import os
import textwrap
import types

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import analysis as janalysis
from mxnet_tpu import nd as jnd
from mxnet_tpu import observability as jobs
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.observability import profiling as jprof
from mxnet_tpu.parallel import TrainStep as JTrainStep
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import analysis as tanalysis
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import observability as tobs
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.analysis import astlint, audit as taudit
from mxnet_tpu_torch.inference import GenerationEngine
from mxnet_tpu_torch.models import gpt2 as tgpt2
from mxnet_tpu_torch.observability import profiling as tprof
from mxnet_tpu_torch.parallel import TrainStep

PKG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "mxnet_tpu_torch")


# -- fingerprints & recompile causes -----------------------------------------
def _arrays(*specs):
    return [np.ones(s, dtype=d) for s, d in specs]


def test_fingerprint_diff_equals_jax():
    """Shape, dtype, static and arity changes: the same (cause, detail) in
    both packages (``tests/test_analysis.py::
    test_fingerprint_diff_distinct_causes``)."""
    cases = {
        "base": (_arrays(((2, 3), np.float32), ((2, 4), np.float32)),
                 {"lr": 0.1}),
        "shape": (_arrays(((6, 3), np.float32), ((2, 4), np.float32)),
                  {"lr": 0.1}),
        "dtype": (_arrays(((2, 3), np.float16), ((2, 4), np.float32)),
                  {"lr": 0.1}),
        "static": (_arrays(((2, 3), np.float32), ((2, 4), np.float32)),
                   {"lr": 0.5}),
        "arity": (_arrays(((2, 3), np.float32)), {"lr": 0.1}),
    }
    for side in (janalysis, tanalysis):
        fps = {k: side.Fingerprint.of(a, **st) for k, (a, st) in
               cases.items()}
        got = {k: side.fingerprint_diff(fps["base"], fp)
               for k, fp in fps.items()}
        if side is janalysis:
            want = got
    assert got == want
    assert want["shape"] == ("shape", "arg0: [2, 3] -> [6, 3]")
    assert want["base"] == ("identical", "")


def _guard_events(side, obs, tmp_path, script):
    d = str(tmp_path / side.__name__.split(".")[0])
    obs.enable(d)
    try:
        labels = script(side)
        obs.shutdown()
        events = [{k: e.get(k) for k in ("reason", "cause", "detail",
                                          "shapes", "dtypes", "static")}
                  for e in obs.read_events(d) if e["event"] == "recompile"]
    finally:
        obs.disable()
    return labels, events


def test_recompile_guard_events_equal_jax(tmp_path):
    """``RecompileGuard`` over the same fingerprint sequence: the same
    labels, counter values and ``recompile`` events (causes, details,
    shapes), with the label map and the per-family groups
    (``tests/test_analysis.py:198-243``)."""
    def script(side):
        guard = side.RecompileGuard("analysis_parity_recompiles_total",
                                    label_map={"static": "hyperparams"})
        fp = side.Fingerprint.of
        f1 = fp(_arrays(((2, 3), np.float32)), k=1)
        f2 = fp(_arrays(((6, 3), np.float32)), k=1)
        f3 = fp(_arrays(((6, 3), np.float32)), k=2)
        out = [guard.observe(f1), guard.observe(f1), guard.observe(f2),
               guard.observe(f3), guard.observe(f1, reason="forced")]
        win = fp(_arrays(((4, 8, 16), np.float32)), key="w")
        step = fp(_arrays(((8, 16), np.float32)), key="s")
        step2 = fp(_arrays(((2, 16), np.float32)), key="s")
        out += [guard.observe(win, reason="window", group="window"),
                guard.observe(step, group="step"),
                guard.observe(step2, group="step"), len(guard)]
        return out

    try:
        jl, je = _guard_events(janalysis, jobs, tmp_path, script)
        tl, te = _guard_events(tanalysis, tobs, tmp_path, script)
    finally:
        jobs.REGISTRY.reset("analysis_parity_recompiles_total")
        tobs.REGISTRY.reset("analysis_parity_recompiles_total")
    assert tl == jl == ["first", None, "shape", "hyperparams", None,
                        "window", "first", "shape", 6]
    assert te == je


def _train_step_causes(side, tmp_path):
    """JAX's TrainStep call sequence: first, a batch-shape change, a label
    dtype change. Returns the recompile events' (reason, cause, detail)."""
    mx = jmx if side == "jax" else tmx
    d = str(tmp_path / side)
    obs = jobs if side == "jax" else tobs
    obs.enable(d)
    try:
        mx.random.seed(0)
        with mx.cpu():
            net = mx.gluon.nn.Dense(4, in_units=3)
            net.initialize()
        ones = (lambda s, dt="float32": jnd.ones(s, dtype=dt)) \
            if side == "jax" else \
            (lambda s, dt="float32": torch.ones(s, dtype=getattr(torch, dt)))
        net(ones((2, 3)))
        opt = (jopt if side == "jax" else topt).SGD(learning_rate=0.1)
        cls = JTrainStep if side == "jax" else TrainStep
        ts = cls(net, lambda out, y: ((out - y) ** 2).mean(), opt)
        ts(ones((2, 3)), ones((2, 4)))
        ts(ones((6, 3)), ones((6, 4)))
        ts(ones((6, 3)), ones((6, 4), "int32"))
        obs.shutdown()
        return [(e["reason"], e["cause"], e["detail"])
                for e in obs.read_events(d) if e["event"] == "recompile"]
    finally:
        obs.disable()


def test_train_step_recompile_causes_equal_jax(tmp_path):
    """The live TrainStep path: the shape and dtype recompiles land in the
    event log with JAX's causes and details. (An lr-multiplier edit is a
    new JAX program and no new port one: the port sends the rates as
    data; a change of the optimizer's scalar hyperparameters is its
    ``hyperparams`` cause, ``test_hyperparams_change_is_a_recompile``.)"""
    port = _train_step_causes("port", tmp_path)
    assert port == _train_step_causes("jax", tmp_path)
    assert port[1] == ("shape", "shape", "arg0: [2, 3] -> [6, 3]")
    assert port[2][:2] == ("dtype", "dtype") and \
        "float32 -> int32" in port[2][2]


def test_hyperparams_change_is_a_recompile(tmp_path):
    tobs.enable(str(tmp_path))
    try:
        with tmx.cpu():
            net = tmx.gluon.nn.Dense(4, in_units=3)
            net.initialize()
        sgd = topt.SGD(learning_rate=0.1)
        ts = TrainStep(net, lambda out, y: ((out - y) ** 2).mean(), sgd)
        x, y = torch.ones(2, 3), torch.ones(2, 4)
        ts(x, y)
        sgd.rescale_grad = 0.5
        ts(x, y)
        sgd.set_lr_mult({net.weight.name: 0.5})  # data: no new program
        ts(x, y)
        tobs.shutdown()
        recs = [e for e in tobs.read_events(str(tmp_path))
                if e["event"] == "recompile"]
    finally:
        tobs.disable()
    assert [(e["reason"], e["cause"]) for e in recs] == \
        [("first", "first"), ("hyperparams", "static")]
    assert "0.5" in recs[1]["detail"]


# -- audit(): carry coverage, memory categories ------------------------------
def _mlp(side, amp=None):
    mx = jmx if side == "jax" else tmx
    mx.random.seed(0)
    with mx.cpu():
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(16, activation="relu"),
                mx.gluon.nn.Dense(4))
        net.initialize()
    if side == "jax":
        x = jnd.ones((4, 6))
        net(x)
        return JTrainStep(net, lambda out, *l: ((out - l[0]) ** 2).mean(),
                          jopt.Adam(learning_rate=1e-3), amp=amp), \
            (x, jnd.zeros((4, 4)))
    x = torch.ones(4, 6)
    net(x)
    return TrainStep(net, lambda out, *l: ((out - l[0]) ** 2).mean(),
                     topt.Adam(learning_rate=1e-3), amp=amp), \
        (x, torch.zeros(4, 4))


@pytest.mark.parametrize("window", [None, 3])
def test_train_step_audit_carry_fully_in_place(window):
    """The bf16 step's and the window's carry (4 parameters + 8 Adam
    moments, as JAX's) is written in place, their products are bf16 and
    no op is f64 (``tests/test_analysis.py:293-312``)."""
    ts, batch = _mlp("port", amp="bfloat16")
    audit = ts.audit(*batch, window=window)
    jts, jbatch = _mlp("jax", amp="bfloat16")
    jaudit = jts.audit(*jbatch, window=window, compile=False)
    assert len(audit.carry_indices) == len(jaudit.carry_indices) == 12
    assert audit.carry_donation() == 1.0, audit.carry_missing()
    assert not audit.lowered.ops_with_dtype("f64")
    dots = audit.lowered.dot_dtypes()
    assert set(dots) == {"bf16"} and dots["bf16"] >= 2 * (window or 1)
    assert audit.compiled is None and "cpu" in audit.why_not_compiled
    assert audit.summary()["carry"]["donation_coverage"] == 1.0
    # the record's kernel: one Adam launch a step
    assert audit.lowered.kernel_counts() == {
        ("mxnet_tpu_torch.ops.optimizer", None): window or 1}


def _tiny_gpt2(side):
    if side == "jax":
        from mxnet_tpu.models import gpt2

        jmx.random.seed(0)
        net = gpt2.get_gpt2("gpt2_tiny", dropout=0.0, num_layers=2,
                            units=32, num_heads=2, max_length=64,
                            vocab_size=64)
        net.initialize()
        net(jnd.array(np.zeros((1, 4), np.int32)))
        return net
    return tgpt2.get_gpt2("gpt2_117m", dropout=0.0, num_layers=2, units=32,
                          num_heads=2, max_length=64, vocab_size=64,
                          device="cpu", seed=0)


def _engines():
    net = _tiny_gpt2("port")
    kw = dict(batch_size=2, max_length=64, prefill_buckets=(8, 16),
              device="cpu")
    return {"dense": GenerationEngine(net, **kw),
            "paged": GenerationEngine(net, paged=True, page_size=16, **kw),
            "spec": GenerationEngine(net, paged=True, page_size=16,
                                     draft_net=net, speculate_k=2, **kw)}


def test_engine_audits_update_their_cache_in_place():
    """Every serving program updates its whole cache carry in place and
    holds no host transfer: dense decode (2 layers x (k, v), as JAX's 4) and
    prefill, paged decode and prefill, copy-on-write (the pools and the
    table), the speculative draft, verify and prefill (both pools)."""
    engs = _engines()
    want = {("dense", "decode", None): 4, ("dense", "decode", 8): 4,
            ("paged", "decode", None): 4, ("paged", "decode", 8): 4,
            ("paged", "cow", None): 5, ("spec", "decode", None): 4,
            ("spec", "verify", None): 4, ("spec", "decode", 8): 8}
    for (name, program, bucket), n in want.items():
        audit = engs[name].audit(bucket=bucket, program=program)
        assert len(audit.carry_indices) == n, (name, program, bucket)
        assert audit.carry_donation() == 1.0, (name, program,
                                               audit.carry_missing())
        assert not audit.lowered.host_transfers()
    # the paged decode reads the cache through the kernel: no gather of
    # the pool materializes it
    mem = engs["paged"].audit().memory
    assert not mem.materialization_kinds()
    with pytest.raises(ValueError):
        engs["dense"].audit(program="cow")
    with pytest.raises(ValueError):
        engs["paged"].audit(program="verify")


def test_engine_memory_categories_equal_jax():
    """The paged decode's ``params`` and ``kv_pages`` bytes (the weights;
    the pools and the page table) equal JAX's memory report."""
    from mxnet_tpu.inference import GenerationEngine as JEngine

    jeng = JEngine(_tiny_gpt2("jax"), batch_size=2, max_length=64,
                   prefill_buckets=(8, 16), paged=True, page_size=16)
    jmem = jeng.audit(compile=False).memory.by_category
    tmem = _engines()["paged"].audit().memory.by_category
    assert tmem["params"] == jmem["params"]
    assert tmem["kv_pages"] == jmem["kv_pages"]


def test_memory_estimate_pins_what_the_input_storages_hold():
    """The estimate's pinned inputs equal what the real input tensors'
    storages hold (``input_storage_bytes``, read from the storages and not
    from the record's shapes): exactly for the step, the window and a dense
    decode; for the paged decode, less the spare last entry of the flat
    buffer its page table views, which only copy-on-write writes."""
    for window in (None, 3):
        ts, batch = _mlp("port")
        audit = ts.audit(*batch, window=window)
        assert audit.memory.input_bytes == audit.lowered.input_storage_bytes
    engs = _engines()
    dense = engs["dense"].audit()
    assert dense.memory.input_bytes == dense.lowered.input_storage_bytes
    eng = engs["paged"]
    spare = (eng._table_flat.numel() - eng.page_table.numel()) * 4
    paged = eng.audit()
    assert paged.memory.input_bytes + spare == \
        paged.lowered.input_storage_bytes


def test_split_partials_are_live_at_the_read_only():
    """A split decode read records the partials its launch allocates as
    scratch: in the temporaries at its own row, and gone after it."""
    from mxnet_tpu_torch.ops import paged_attention as pa

    h, ch, ps, pages = 2, 64, 16, 20
    q = torch.randn(1, h, 1, ch)
    k, v = (torch.randn(pages + 1, h, ps, ch) for _ in range(2))
    table = torch.arange(1, pages + 1, dtype=torch.int32).view(1, pages)
    pos = torch.tensor([pages * ps - 1], dtype=torch.int32)

    def fn():
        return ((pa.paged_attention_read(q, k, v, table, pos) * 2).sum(),)

    rep = tanalysis.audit_program(fn)
    splits = -(-pages * ps // pa.SPLIT_KEYS)
    part = h * splits * (ch + 2) * 4
    first = len(rep.inputs)  # the inputs' rows come first
    read, mul = rep.values[first], rep.values[first + 1]
    assert read.op == "custom_call" and mul.op == "mul"
    assert splits > 1 and read.scratch == part and mul.scratch == 0
    mem = tanalysis.memory_report(rep)
    out = h * ch * 4
    assert mem.temp_peak_bytes == mem.timeline[first][2] == out + part
    assert mem.timeline[first + 1][2] == 2 * out  # the product: no partials


def test_audit_changes_no_random_stream_parameter_or_token():
    ts, batch = _mlp("port")
    w0 = [p.detach().clone() for _, p in ts._plist]
    m0 = [t.clone() for st in ts.opt_state.values() for t in st]
    rng = torch.random.get_rng_state()
    ts.audit(*batch)
    ts.audit(*batch, window=2)
    assert torch.equal(rng, torch.random.get_rng_state())
    assert all(torch.equal(a, p.detach()) for a, (_, p) in zip(w0, ts._plist))
    assert all(torch.equal(a, t) for a, t in zip(
        m0, (t for st in ts.opt_state.values() for t in st)))

    def run(audited):
        eng = GenerationEngine(
            _tiny_gpt2("port"), batch_size=2, max_length=64,
            prefill_buckets=(8,), paged=True, page_size=4,
            sampling="temperature", device="cpu")
        toks = [eng.prefill([1, 2, 3], 0), eng.prefill([4, 5], 1)]
        for _ in range(6):
            if audited:
                eng.audit()
                eng.audit(bucket=8)
                eng.audit(program="cow")
            toks.append(eng.decode_step()[0].tolist())
        return toks

    assert run(True) == run(False)


# -- kernel records -----------------------------------------------------------
def test_each_kernel_records_itself_once():
    """A kernel wrapper under a record is one custom_call op with its CUDA
    function, its counter and the products of the function it computes
    (causal flash at the full T^2); its plain version records nothing."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import layernorm as ln
    from mxnet_tpu_torch.ops import softmax_xent as sx
    from mxnet_tpu_torch.observability import goodput

    b, h, t, d = 2, 2, 16, 64
    q, k, v = (torch.randn(b, h, t, d, requires_grad=True) for _ in range(3))
    x = torch.randn(b * t, 32, requires_grad=True)
    gamma, beta = torch.ones(32, requires_grad=True), torch.zeros(32)
    lbl = torch.randint(0, 32, (b * t,), dtype=torch.int32)

    def fn():
        o = fa.flash_attention(q, k, v, causal=True)
        y = ln.layer_norm(x, gamma, beta, 1e-5)
        loss = sx.softmax_cross_entropy_fused(y, lbl).mean() + o.sum()
        return torch.autograd.grad(loss, [q, k, v, x, gamma])

    rep = tanalysis.audit_program(fn)
    kernels = [(o.kernel, o.flops) for o in rep.kernels()]
    two = 4.0 * b * h * t * t * d  # two products over the full T x T
    assert kernels == [("flash_fwd_tc_kernel", two),
                       ("layernorm_fwd_warp_kernel", 0.0),
                       ("xent_fwd_kernel", 0.0), ("xent_bwd_kernel", 0.0),
                       ("layernorm_bwd_warp_kernel", 0.0),
                       ("layernorm_bwd_merge_kernel", 0.0),
                       ("flash_bwd_dkv_tc_kernel", two),
                       ("flash_bwd_dq_tc_kernel", two)]
    assert goodput.program_flops(rep).total == 3 * two
    assert not rep.dots()  # no plain version ran
    counts = rep.kernel_counts()
    assert counts[("mxnet_tpu_torch.ops.layernorm", "bwd_merge")] == 1
    assert not taudit.recording()


def test_kernel_base_names():
    f = taudit.kernel_base_name
    assert f("_Z25layernorm_fwd_warp_kernelIffLi8EEvPKT_PKT0_S5_PS0_iif") \
        == "layernorm_fwd_warp_kernel"
    assert f("_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11Fill"
             "FunctorIfEESt5arrayIPcLm1EEEEviT0_T1_") == \
        "vectorized_elementwise_kernel"
    assert f("void at::native::vectorized_elementwise_kernel<4, "
             "at::native::FillFunctor<float>>(int, float)") == \
        "vectorized_elementwise_kernel"
    assert f("paged_attention_kernel") == "paged_attention_kernel"
    assert f("_ZN45_GLOBAL__N__be43a5fb_12_int8_gemm_cu_ed628c7c22int8_gemm_"
             "wgmma_kernelILi64EfEEv14CUtensorMap_st") == \
        "int8_gemm_wgmma_kernel"
    assert f("at::cuda::(anonymous namespace)::spin_kernel(long)") == \
        "spin_kernel"


# -- memory and schedule models -------------------------------------------------
def test_memory_and_schedule_models():
    w = torch.nn.Parameter(torch.randn(64, 32))
    x = torch.randn(128, 32)

    def fn():
        y = (x @ w.t()).relu()
        g, = torch.autograd.grad(y.sum(), [w])
        with torch.no_grad():
            w.sub_(g, alpha=0.1)
        return (y.detach().sum(),)

    rep = tanalysis.audit_program(fn, carry=[w], inputs=[x])
    mem = tanalysis.memory_report(rep, categories={0: "params", 1: "batch"})
    assert mem.input_bytes == (64 * 32 + 128 * 32) * 4
    assert mem.donated_bytes == 64 * 32 * 4
    assert mem.by_category["params"] == 64 * 32 * 4
    assert mem.peak_bytes >= mem.input_bytes + 128 * 64 * 4
    sched = tanalysis.schedule_report(rep)
    flops = 2.0 * 128 * 64 * 32 * 2  # forward + weight gradient
    assert sched.flops_total == flops
    assert sched.constants["mfu_peak_flops"] == 989e12
    assert sched.critical_path_seconds >= sched.compute_seconds > 0
    assert set(sched.op_class_seconds) <= {"dot", "fusion", "copy"}
    # the f32 products at 3xTF32's rate unless a knob prices them all
    f32 = sched.op_class_seconds["dot"]
    tconfig.set("sched_peak_flops", 1e12)
    try:
        one = tanalysis.schedule_report(rep).op_class_seconds["dot"]
    finally:
        tconfig._values.pop("sched_peak_flops", None)
    assert one > f32 and one == pytest.approx(flops / 1e12, rel=1e-9)
    assert tanalysis.comm_report(rep).summary()["n_collectives"] == 0


@pytest.mark.parametrize("name", ["sched_peak_flops", "sched_hbm_gbps"])
def test_sched_knob_matches_jax(name):
    """Name, type, default and environment variables as in
    ``mxnet_tpu.config``; 0 / empty selects each model's own defaults (the
    H100's here, one v5e's there)."""
    from mxnet_tpu import config as jconfig

    assert tconfig._KNOBS[name][:3] == jconfig._KNOBS[name][:3]


# -- measured windows ---------------------------------------------------------------
def test_event_windows_sit_beside_the_step_rows():
    """A capture on the card keeps each step row as the window by its
    kernel rows, in every entry point alike, and adds the CUDA-event window
    of each traced call as a separately named ``prof_step.events`` span."""
    rows = [tprof.OpRow("/device:GPU:0", "stream 7", "paged_attention_kernel",
                        s, 1e3) for s in (2e6, 9e6)]
    spans = [tprof.SpanRow(tprof.PROF_STEP_SPAN, 2e6, 4e6, step=0),
             tprof.SpanRow(tprof.PROF_STEP_SPAN, 9e6, 3e6, step=1)]
    rep = tprof.MeasuredReport(op_rows=rows, spans=spans)
    tprof._event_windows(rep, [1.25, 0.75])
    assert len(rep.op_rows) == 2
    assert rep.step_seconds() == [4e-3, 3e-3]
    ev = rep.span_breakdown()[tprof.EVENTS_SPAN]
    assert ev["count"] == 2 and ev["seconds"] == pytest.approx(2e-3)
    assert [(s.step, s.start_ns) for s in rep.spans
            if s.name == tprof.EVENTS_SPAN] == [(0, 2e6), (1, 9e6)]


# -- op classes, calibration ----------------------------------------------------------
def test_op_class_table():
    """One vocabulary for both sides of calibrate: the record's aten ops
    and a CPU trace's rows, the card's kernels by name."""
    table = {
        "aten::mm": "dot", "aten::addmm": "dot", "aten::bmm": "dot",
        "aten::convolution": "conv", "aten::convolution_backward": "conv",
        "aten::add": "fusion", "aten::native_layer_norm": "fusion",
        "aten::_to_copy": "fusion", "aten::copy_": "copy",
        "aten::clone": "copy", "custom_call": "custom_call",
        "copy_to_host": "copy",
        "_Z25layernorm_fwd_warp_kernelIffLi8EEvPKT_PKT0_S5_PS0_iif":
            "custom_call",
        "void int8_gemm_wgmma_kernel<128, float>(CUtensorMap)": "custom_call",
        "paged_attention_kernel": "custom_call",
        "nvjet_tst_192x192_64x3_2x1_v_bz_TNT": "dot",
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n": "dot",
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::AddFunctor<float>>(int)": "fusion",
        "void at::native::reduce_kernel<512, 1>(at::native::ReduceOp)":
            "fusion",
        "cudnn::conv2d_grouped_direct_kernel": "conv",
        "void cublasLt::splitKreduce_kernel<32, 16, int, float>": "dot",
        "void at_cuda_detail::cub::DeviceReduceKernel<float>": "fusion",
        "Memcpy DtoD (Device -> Device)": "copy", "Memset (Device)": "copy",
        "dot.3": "dot", "fusion.2": "fusion", "reduce.1": "other",
        "all-reduce-start.1": "all_reduce",
    }
    assert {n: tprof.op_class(n) for n in table} == table


def _fake_schedule(classes, crit=1e-6, overlap=0.0):
    return types.SimpleNamespace(op_class_seconds=classes,
                                 critical_path_seconds=crit,
                                 overlap_fraction=overlap)


def _fake_measured(prof, classes, steps=1):
    rows, t = [], 0.0
    for cls, secs in classes.items():
        name = {"dot": "dot.1", "fusion": "fusion.1",
                "all_reduce": "all-reduce.1",
                "custom_call": "paged_attention_kernel"}.get(cls, "reduce.1")
        rows.append(prof.OpRow(device="/device:TPU:0", lane="XLA Ops",
                               name=name, start_ns=t,
                               dur_ns=secs * steps * 1e9))
        t += secs * steps * 1e9
    spans = [prof.SpanRow(name=prof.PROF_STEP_SPAN, start_ns=0, dur_ns=1e6,
                          step=i) for i in range(steps)]
    return prof.MeasuredReport(op_rows=rows, spans=spans)


@pytest.mark.parametrize("pred,meas,steps", [
    ({"dot": 1e-6, "fusion": 2e-6, "other": 5e-7},
     {"dot": 1e-3, "fusion": 2e-3, "other": 5e-4}, 1),
    ({"dot": 1e-6, "fusion": 2e-6, "all_reduce": 1e-6},
     {"dot": 1e-3, "fusion": 2e-3, "all_reduce": 1e-2}, 1),
    ({"dot": 1e-6}, {"dot": 1e-3}, 3)])
def test_calibrate_equals_jax(pred, meas, steps):
    """JAX's synthetic schedules and traces (``tests/test_profiling.py:
    168-203``): the same ``summary()``, drift flags and knobs, but that a
    drifting collective points at the link-speed constant the port prices
    collectives at, where JAX names its ICI/DCN knobs."""
    out = [prof.calibrate(_fake_schedule(pred),
                          _fake_measured(prof, meas, steps), band=3.0,
                          emit=False).summary()
           for prof in (jprof, tprof)]
    for d in out[0]["drifting"]:
        if d["op_class"] == "all_reduce":
            assert d["knob"] == \
                "MXNET_TPU_SCHED_ICI_GBPS/MXNET_TPU_SCHED_DCN_GBPS"
            d["knob"] = "analysis.schedule.DEFAULT_ICI_GBPS"
    assert out[1] == out[0]
    json.dumps(out[1])


def test_calibrate_emits_drift_events(tmp_path):
    tobs.enable(str(tmp_path))
    try:
        cal = tprof.calibrate(
            _fake_schedule({"dot": 1e-6, "fusion": 2e-6,
                            "custom_call": 1e-6}),
            _fake_measured(tprof, {"dot": 1e-3, "fusion": 2e-3,
                                   "custom_call": 1e-2}))
        tobs.shutdown()
        evs = [e for e in tobs.read_events(str(tmp_path))
               if e["event"] == "calibration_drift"]
    finally:
        tobs.disable()
    assert [d["op_class"] for d in cal.drifting] == ["custom_call"]
    assert [e["op_class"] for e in evs] == ["custom_call"]
    assert evs[0]["knob"] == "MXNET_TPU_SCHED_HBM_GBPS"


# -- the hazard linter ------------------------------------------------------------
def _rules(violations):
    return sorted(v.rule for v in violations)


HOT_SRC = textwrap.dedent("""\
    import time
    import numpy as np
    import torch

    def make_step(static, device):
        def step(params, batch):
            if params > 0:                    # JH002
                pass
            x = float(batch)                  # JH001
            v = np.asarray(batch)             # JH001
            y = batch.item()                  # JH001
            t = time.time()                   # JH003
            return params
        fn = step
        return StepGraph(fn, "sig", device)
    """)


def test_lint_hot_path_rules_fire_through_alias():
    vs = astlint.lint_source(HOT_SRC, "mxnet_tpu_torch/x.py")
    assert _rules(vs) == ["JH001", "JH001", "JH001", "JH002", "JH003"]
    lines = {v.rule + ":" + str(v.line) for v in vs}
    assert "JH002:7" in lines and "JH003:12" in lines


def test_lint_port_sync_spellings():
    """The port's host syncs: ``.cpu()``, ``.numpy()``, ``.nonzero()``,
    ``torch.cuda.synchronize()`` in a program handed to ``_run_program``
    (its second argument) or to ``StepGraph`` through a lambda."""
    src = textwrap.dedent("""\
        import torch

        class Engine:
            def run(self):
                def step():
                    a = self.x.cpu()              # JH001
                    b = self.x.nonzero()          # JH001
                    torch.cuda.synchronize()      # JH001
                    return (a, b)
                return self._run_program(("decode",), step)

            def build(self):
                return StepGraph(lambda: self._body(1), "sig", dev)

            def _body(self, k):
                return self.x.numpy()             # JH001

            def _run_program(self, sig, fn):
                return StepGraph(fn, sig, dev)()   # fn: the caller's
        """)
    assert _rules(astlint.lint_source(src, "mxnet_tpu_torch/x.py")) == \
        ["JH001"] * 4


def test_lint_structural_idioms_not_flagged():
    src = textwrap.dedent("""\
        def make(topk):
            def step(params, state):
                if params is not None:        # structural: ok
                    pass
                for name in state:
                    if name not in state:     # structural: ok
                        pass
                k = int(topk)                 # static param: ok
                return params
            return StepGraph(step, "sig", dev)
        """)
    assert astlint.lint_source(src, "mxnet_tpu_torch/x.py") == []


def test_lint_mutable_defaults_and_global_mutation():
    src = textwrap.dedent("""\
        import threading

        _REG = {}
        _lock = threading.Lock()

        def bad(x=[], y={}):                  # JH004 x2
            return x

        def put(k, v):
            _REG[k] = v                       # JH005

        def put_locked(k, v):
            with _lock:
                _REG[k] = v                   # ok

        def rhs_mutation(site):
            h = _REG.setdefault(site, [])     # JH005: mutates via RHS
            return h

        def aug(k):
            _REG[k] += 1                      # JH005: read-modify-write

        def local_only(k, v):
            reg = {}
            reg[k] = v                        # ok: not module-global
            return reg

        def deferred(k, v):
            with _lock:
                def cb():
                    _REG[k] = v               # JH005: cb runs later,
                return cb                     # NOT under the lock
        """)
    assert _rules(astlint.lint_source(src, "m.py")) == \
        ["JH004", "JH004", "JH005", "JH005", "JH005", "JH005"]


@pytest.mark.parametrize("write, flagged", [
    ('launches["fwd"] += 1', []),
    ('launches["fwd"] = 0', []),
    ('_counts["fwd"] += 1', ["JH005"]),
])
def test_lint_launch_counter_is_not_a_registry(write, flagged):
    """A kernel wrapper's module-global ``launches`` tally is exempt from
    JH005 in the one place the rule is defined; any other module-global
    written the same way is still flagged."""
    src = textwrap.dedent(f"""\
        launches = {{"fwd": 0}}
        _counts = {{"fwd": 0}}

        def wrapper(x):
            {write}
            return x
        """)
    assert _rules(astlint.lint_source(src, "mxnet_tpu_torch/ops/k.py")) \
        == flagged


def test_lint_nondeterminism_in_op_modules():
    src = textwrap.dedent("""\
        import numpy as np

        def my_op(x):
            noise = np.random.normal(size=x.shape)     # JH003
            rs = np.random.RandomState(0)              # ok: explicit seed
            return x + noise + rs.normal(size=x.shape)
        """)
    assert _rules(astlint.lint_source(src, "mxnet_tpu_torch/ops/myop.py")) \
        == ["JH003"]
    assert astlint.lint_source(src, "mxnet_tpu_torch/io/loader.py") == []


def test_lint_suppressions_inline_above_def_and_file():
    src = textwrap.dedent("""\
        import numpy as np

        def make():
            def step(p):
                a = np.asarray(p)  # lint: disable=JH001
                # lint: disable=JH001
                b = np.asarray(p)
                c = np.asarray(p)               # still flagged
                return a, b, c
            return StepGraph(step, "s", dev)

        def make2():
            def step2(p):  # lint: disable=all
                return np.asarray(p)
            return StepGraph(step2, "s", dev)
        """)
    vs = astlint.lint_source(src, "m.py")
    assert len(vs) == 1 and vs[0].line == 8
    assert astlint.lint_source(
        "# lint: disable-file=JH004\ndef f(x=[]):\n    return x\n",
        "m.py") == []
    quoted = '"""Docs quoting: # lint: disable-file=JH004"""\n\n' \
        'def f(x=[]):\n    return x\n'
    assert _rules(astlint.lint_source(quoted, "m.py")) == ["JH004"]


def test_lint_registered_extra_hot_paths():
    src = textwrap.dedent("""\
        class TrainStep:
            def _forward_loss(self, batch):
                return float(batch)           # JH001 via registration
        """)
    assert _rules(astlint.lint_source(
        src, "mxnet_tpu_torch/parallel/train_step.py")) == ["JH001"]
    assert astlint.lint_source(src, "mxnet_tpu_torch/parallel/other.py") \
        == []


def test_lint_traced_constant_capture_jh007():
    src = textwrap.dedent("""\
        import numpy as np
        import torch

        TABLE = np.arange(1000).reshape(10, 100)

        def build():
            scale = np.ones((64,))
            def step(x):
                return x @ TABLE + scale      # JH007 x2
            return StepGraph(step, "s", dev)

        def cold(x):
            return x @ TABLE                  # ok: not a hot path

        def shadowed():
            def step(x, TABLE):
                return x @ TABLE              # ok: parameter shadows
            return StepGraph(step, "s", dev)
        """)
    vs = astlint.lint_source(src, "mxnet_tpu_torch/x.py")
    assert _rules(vs) == ["JH007", "JH007"]
    assert {"TABLE", "scale"} == {v.message.split("'")[1] for v in vs}
    rebound = textwrap.dedent("""\
        import numpy as np
        import torch

        X = np.arange(100000)
        X = torch.as_tensor(X, device="cuda")

        def build():
            y = np.ones((64,))
            y = torch.as_tensor(y)
            def step(v):
                return v + X + y
            return StepGraph(step, "s", dev)
        """)
    assert astlint.lint_source(rebound, "mxnet_tpu_torch/x.py") == []


def test_lint_sync_per_dispatch_jh008():
    src = textwrap.dedent("""\
        import numpy as np

        prog = StepGraph(fn, "sig", dev)

        def drive(xs):
            out = []
            for x in xs:
                y = prog()
                out.append(float(y[0]))        # JH008
            return out

        class Engine:
            def loop(self, n):
                for _ in range(n):
                    r = self._run_program(("decode",), self._step)
                    np.asarray(r)              # JH008
                    r[0].item()                # JH008
        """)
    vs = astlint.lint_source(src, "mxnet_tpu_torch/loop.py")
    assert _rules(vs) == ["JH008", "JH008", "JH008"]
    assert "waits on the card" in vs[0].message
    ok = textwrap.dedent("""\
        prog = StepGraph(fn, "sig", dev)

        def drive(xs):
            outs = [prog() for x in xs]
            return [float(o[0]) for o in outs]
        """)
    assert astlint.lint_source(ok, "mxnet_tpu_torch/loop.py") == []


def test_package_is_lint_clean():
    """The port carries no unsuppressed hazard (``tools/torch_lint.py``),
    and every suppression in it gives its reason."""
    vs = astlint.lint_paths([PKG_DIR])
    assert vs == [], "\n".join(str(v) for v in vs)
    for root, _, files in os.walk(PKG_DIR):
        for name in files:
            if not name.endswith(".py") or name == "astlint.py":
                continue
            for line in open(os.path.join(root, name), encoding="utf-8"):
                if "# lint: disable" in line:
                    assert " -- " in line.split("# lint: disable", 1)[1], \
                        f"{name}: a suppression without its reason: {line}"
