"""The port's ``mx.sym``, ``mx.rnn`` cells, ``mx.viz`` and ``mx.operator``
against the JAX package's (mxnet_tpu_torch/symbol, rnn.py,
visualization.py, operator.py): every case of tests/test_symbol.py run in
both packages on the same numpy inputs (composition, argument order,
``infer_shape``, ``simple_bind`` forward and backward, ``grad_req="add"``,
JSON, ``get_internals``, ``Group``, sliced multi-output heads, the
auto-created parameter variables, the creation helpers and ``sym.Custom``),
``symbol.json`` files written by one package loaded and evaluated by the
other, every ``mx.rnn`` cell's unroll, ``print_summary`` and
``plot_network``, CustomOp forward, backward, multi-output, inside a
``StepGraph`` and unregistered, and ``Parameter.var()`` as the parameter's
Symbol variable.

Tolerances: forward values rtol 1e-5, atol 1e-6; gradients rtol 1e-5,
atol 1e-5; shapes, names, JSON node lists and printed tables exactly
equal."""
import json
import re

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.base import MXNetError as JError
from mxnet_tpu_torch.base import MXNetError as TError

from test_torch_vision_layers import name_counters  # noqa: F401

SIDES = (jmx, tmx)
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-5)


def _both(fn):
    """``fn(mx)`` in the JAX package, then in the port on the CPU."""
    j = fn(jmx)
    with tmx.cpu():
        t = fn(tmx)
    return j, t


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else x


def _close(a, b, tol=FWD):
    for x, y in zip(_np(a), _np(b)):
        np.testing.assert_allclose(x, y, **tol)


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


# -- tests/test_symbol.py, case by case ----------------------------------------
def test_compose_and_eval():
    def run(mx):
        a, b = mx.sym.var("a"), mx.sym.var("b")
        return (a * 2 + b).eval(a=mx.nd.array(_x((2,), 1)),
                                b=mx.nd.array(_x((2,), 2)))
    _close(*_both(run))


def test_list_arguments_order_and_infer_shape():
    def run(mx):
        x, w = mx.sym.var("x"), mx.sym.var("w")
        y = mx.sym.FullyConnected(x, w, None, num_hidden=3, no_bias=True)
        return y.list_arguments(), y.infer_shape(x=(2, 5), w=(3, 5)), \
            y.infer_shape(x=(2, 5))
    (ja, js, jp), (ta, ts, tp) = _both(run)
    assert ja == ta == ["x", "w"]
    assert js == ts and ts[1] == [(2, 3)]
    # the FullyConnected hint solves the weight's shape from the data's
    assert jp == tp and tp[0] == [(2, 5), (3, 5)]


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_simple_bind_forward_backward(grad_req):
    x0, w0 = _x((3, 4), 3), _x((2, 4), 4)

    def run(mx):
        x, w = mx.sym.var("x"), mx.sym.var("w")
        y = mx.sym.FullyConnected(x, w, None, num_hidden=2, no_bias=True)
        ex = mx.sym.sum(y * y).simple_bind(x=(3, 4), w=(2, 4),
                                           grad_req=grad_req)
        ex.arg_dict["x"][:] = x0
        ex.arg_dict["w"][:] = w0
        (out,) = ex.forward(is_train=True)
        ex.backward()
        first = ex.grad_dict["w"].asnumpy().copy()
        ex.forward(is_train=True)
        ex.backward()
        return out, first, ex.grad_dict["w"], ex.grad_dict["x"]
    (jo, jg1, jg2, jgx), (to, tg1, tg2, tgx) = _both(run)
    _close([jo], [to])
    _close([jg1, jg2, jgx], [tg1, tg2, tgx], GRAD)
    # "add" accumulates the second backward onto the first
    mult = 2.0 if grad_req == "add" else 1.0
    np.testing.assert_allclose(_np(tg2), mult * tg1, **GRAD)


def test_simple_bind_honors_explicit_scalar_shape():
    def run(mx):
        a, b = mx.sym.var("a"), mx.sym.var("b")
        ex = mx.sym.add(a, b).simple_bind(a=(), b=())
        ex.arg_dict["a"][:] = 2.0
        ex.arg_dict["b"][:] = 3.0
        return ex.arg_dict["a"].shape, ex.forward()[0]
    (js, jo), (ts, to) = _both(run)
    assert js == ts == ()
    _close([jo], [to])


def test_json_roundtrip_and_arithmetic_scalars():
    a0, b0 = _x((3,), 5), _x((3,), 6)

    def run(mx):
        a, b = mx.sym.var("a"), mx.sym.var("b")
        d = mx.sym.tanh(mx.sym.add(a, b))
        d2 = mx.sym.load_json(d.tojson())
        e = (a + 1) * 3 / 2 - 0.5
        kw = dict(a=mx.nd.array(a0), b=mx.nd.array(b0))
        return (d.tojson(), d.eval(**kw)[0], d2.eval(**kw)[0],
                e.eval(a=mx.nd.array(a0))[0])
    (jj, *jv), (tj, *tv) = _both(run)
    _close(jv, tv)
    _close(tv[:1], tv[1:2], dict(rtol=0, atol=0))
    assert _nodes(jj) == _nodes(tj)


def _nodes(js):
    """A JSON graph without its auto-generated node names."""
    g = json.loads(js)
    for n in g["nodes"]:
        if n["op"] != "null":
            n.pop("name")
    return g


def test_get_internals_feature_extraction():
    data0 = _x((2, 1, 12, 12), 7)
    w0, b0 = _x((4, 1, 3, 3), 8, 0.3), _x((4,), 9, 0.1)

    def run(mx):
        data = mx.sym.var("data")
        c1 = mx.sym.Convolution(data, mx.sym.var("c1w"), mx.sym.var("c1b"),
                                num_filter=4, kernel=(3, 3), name="conv0")
        a1 = mx.sym.Activation(c1, act_type="tanh", name="act0")
        p1 = mx.sym.Pooling(a1, kernel=(2, 2), stride=(2, 2),
                            pool_type="max", name="pool0")
        f1 = mx.sym.FullyConnected(mx.sym.flatten(p1), mx.sym.var("fw"),
                                   mx.sym.var("fb"), num_hidden=10,
                                   name="fc0")
        internals = f1.get_internals()
        ex = internals["pool0_output"].simple_bind(
            data=(2, 1, 12, 12), c1w=(4, 1, 3, 3), c1b=(4,))
        ex.arg_dict["data"][:] = data0
        ex.arg_dict["c1w"][:] = w0
        ex.arg_dict["c1b"][:] = b0
        with pytest.raises((JError, TError), match="not found"):
            internals["nope_output"]
        return internals.list_outputs(), ex.forward()[0]
    (jn, jo), (tn, to) = _both(run)
    assert jn == tn and "conv0_output" in tn and "data" in tn
    assert to.shape == (2, 4, 5, 5)
    _close([jo], [to])


def test_group_multi_head_and_backward():
    a0 = _x((2, 3), 10, 0.5)

    def run(mx):
        a = mx.sym.var("a")
        g = mx.sym.Group([mx.sym.tanh(a, name="t0"), mx.sym.sum(a * a,
                                                                name="s0")])
        ex = g.simple_bind(a=(2, 3))
        ex.arg_dict["a"][:] = a0
        outs = ex.forward(is_train=True)
        ex.backward()
        g2 = mx.sym.load_json(g.tojson())
        return (g.list_outputs(), g2.list_outputs(), outs,
                g2.eval(a=mx.nd.array(a0)), ex.grad_dict["a"])
    (jn, jn2, jo, je, jg), (tn, tn2, to, te, tg) = _both(run)
    assert jn == tn == jn2 == tn2 == ["t0_output", "s0_output"]
    _close(jo + je, to + te)
    _close([jg], [tg], GRAD)
    np.testing.assert_allclose(_np(tg), (1 - np.tanh(a0) ** 2) + 2 * a0,
                               **GRAD)


def test_sliced_multi_output_names_align():
    x0 = _x((4, 3), 11)

    def run(mx):
        sym = mx.sym
        x = sym.var("x")
        bn = sym.BatchNorm(x, sym.var("g"), sym.var("b"), sym.var("m"),
                           sym.var("v"), name="bn0")
        grp = sym.Group([bn[1], sym.tanh(x, name="tx")])
        ex = grp.simple_bind(x=(4, 3), g=(3,), b=(3,), m=(3,), v=(3,))
        ex.arg_dict["x"][:] = x0
        grp2 = sym.Group([bn, sym.tanh(x, name="tx2")])
        ex2 = grp2.simple_bind(x=(4, 3), g=(3,), b=(3,), m=(3,), v=(3,))
        with pytest.raises((JError, TError), match="out of range"):
            grp2[7]
        return (bn.list_outputs(), bn[1].list_outputs(), grp.list_outputs(),
                grp2.list_outputs(), grp2[-1].name, ex.forward(),
                [o.shape for o in ex2.forward()])
    j, t = _both(run)
    assert j[:5] == t[:5] and j[6] == t[6]
    assert t[2] == ["bn0_output1", "tx_output"] and len(t[6]) == 4
    _close(j[5], t[5])


def test_sym_auto_param_vars_by_keyword():
    def run(mx):
        x, b = mx.sym.var("data"), mx.sym.var("mybias")
        y = mx.sym.FullyConnected(x, bias=b, num_hidden=4, name="fc")
        ex = y.bind(args={"data": mx.nd.array(_x((2, 3), 12)),
                          "fc_weight": mx.nd.array(_x((4, 3), 13)),
                          "mybias": mx.nd.array(_x((4,), 14))})
        return y.list_arguments(), ex.forward()[0]
    (ja, jo), (ta, to) = _both(run)
    assert ja == ta == ["data", "fc_weight", "mybias"]
    _close([jo], [to])


def test_creation_helpers_and_sym_custom():
    x0 = _x((2, 2), 15)

    def run(mx):
        sym = mx.sym
        outs = sym.Group([sym.zeros((2, 3)), sym.ones(4),
                          sym.linspace(0.0, 1.0, 5)]).simple_bind().forward()
        y = sym.Custom(sym.var("x"), op_type=f"sq_{mx.__name__}")
        ex = y.simple_bind(x=(2, 2))
        ex.arg_dict["x"][:] = x0
        (out,) = ex.forward(is_train=True)
        ex.backward()
        return outs, out, ex.grad_dict["x"], y.tojson()
    (jo, jc, jg, jj), (to, tc, tg, tj) = _both(run)
    _close(jo + [jc], to + [tc])
    _close([jg], [tg], GRAD)
    np.testing.assert_allclose(_np(tc), x0 * x0, **FWD)
    np.testing.assert_allclose(_np(tg), 2 * x0, **GRAD)
    assert json.loads(tj)["nodes"][1]["op"] == "Custom:sq_mxnet_tpu_torch"


# -- symbol.json across the packages --------------------------------------------
def _conv_net(sym):
    data = sym.var("data")
    c = sym.Convolution(data, num_filter=3, kernel=(3, 3), pad=(1, 1),
                        name="conv")
    h = sym.Activation(c, act_type="relu")
    p = sym.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="avg")
    f = sym.FullyConnected(sym.flatten(p), num_hidden=5, name="fc")
    return sym.Group([sym.softmax(f, axis=-1), sym.sum(p, axis=(1, 2, 3))])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_json_crosses_packages(writer, tmp_path):
    """A symbol.json written by one package loads and evaluates in the
    other: the same arguments, node list and outputs."""
    src = jmx if writer == "jax" else tmx
    dst = tmx if writer == "jax" else jmx
    fname = str(tmp_path / "net-symbol.json")
    _conv_net(src.sym).save(fname)
    feed = {"data": _x((2, 2, 6, 6), 16), "conv_weight": _x((3, 2, 3, 3), 17,
                                                            0.3),
            "conv_bias": _x((3,), 18, 0.1), "fc_weight": _x((5, 27), 19, 0.3),
            "fc_bias": _x((5,), 20, 0.1)}

    def run(mx, s):
        return s.list_arguments(), s.eval(**{k: mx.nd.array(v)
                                             for k, v in feed.items()})
    s_src, s_dst = src.sym.load(fname), dst.sym.load(fname)
    assert json.loads(s_src.tojson()) == json.loads(s_dst.tojson())
    with tmx.cpu():
        (a1, o1), (a2, o2) = run(src, s_src), run(dst, s_dst)
    assert a1 == a2
    _close(o1, o2)


# -- mx.rnn cells -------------------------------------------------------------
def _cell_feed(args, seed):
    rs = np.random.RandomState(seed)
    return {a: rs.normal(0, 0.3, ()).astype(np.float32) for a in args}


def _run_cells(make, length, in_shape, layout="NTC", seed=21):
    """Unroll ``make(mx)`` in both packages, bind the same weights (shapes
    from infer_shape) and compare the merged outputs and every state."""
    def run(mx):
        cell = make(mx)
        outs, states = cell.unroll(length, mx.sym.var("data"), layout=layout,
                                   merge_outputs=True)
        flat = [s for st in states for s in (st if isinstance(st, list)
                                             else [st])]
        g = mx.sym.Group([outs] + flat)
        arg_shapes, out_shapes, _ = g.infer_shape(data=in_shape)
        rs = np.random.RandomState(seed)
        feed = {n: rs.normal(0, 0.3, s).astype(np.float32)
                for n, s in zip(g.list_arguments(), arg_shapes)}
        ex = g.bind(args={k: mx.nd.array(v) for k, v in feed.items()})
        return g.list_arguments(), out_shapes, ex.forward()
    (ja, js, jo), (ta, ts, to) = _both(run)
    assert ja == ta and js == ts
    _close(jo, to)
    return ts


def test_lstm_cell_unroll_matches_manual():
    H, C, B, T = 4, 3, 2, 3
    rs = np.random.RandomState(0)
    wi, wh = rs.normal(0, 0.2, (4 * H, C)), rs.normal(0, 0.2, (4 * H, H))
    bi, bh = rs.normal(0, 0.1, (4 * H,)), np.zeros(4 * H)
    x = rs.normal(size=(B, T, C)).astype(np.float32)
    feed = {"data": x, "l0_i2h_weight": wi, "l0_i2h_bias": bi,
            "l0_h2h_weight": wh, "l0_h2h_bias": bh}

    def run(mx):
        cell = mx.rnn.LSTMCell(num_hidden=H, prefix="l0_", forget_bias=0.0)
        outs, _ = cell.unroll(T, mx.sym.var("data"), layout="NTC",
                              merge_outputs=True)
        return outs.bind(args={k: mx.nd.array(np.float32(v))
                               for k, v in feed.items()}).forward()[0]
    jo, to = _both(run)
    _close([jo], [to])

    def sigmoid(v):
        return 1 / (1 + np.exp(-v))

    h, c, expect = np.zeros((B, H)), np.zeros((B, H)), []
    for t in range(T):
        g = x[:, t] @ wi.T + bi + h @ wh.T + bh
        i, f, gg, o = np.split(g, 4, axis=1)
        c = sigmoid(f) * c + sigmoid(i) * np.tanh(gg)
        h = sigmoid(o) * np.tanh(c)
        expect.append(h)
    np.testing.assert_allclose(_np(to), np.stack(expect, 1), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_cells_unroll(layout):
    """RNNCell, LSTMCell and GRUCell in a SequentialRNNCell, and a
    BidirectionalCell, each unrolled in both packages."""
    def seq(mx):
        s = mx.rnn.SequentialRNNCell()
        s.add(mx.rnn.GRUCell(5, prefix="g0_"))
        s.add(mx.rnn.LSTMCell(6, prefix="l0_"))
        s.add(mx.rnn.RNNCell(7, activation="relu", prefix="r0_"))
        return s
    in_shape = (2, 4, 3) if layout == "NTC" else (4, 2, 3)
    shapes = _run_cells(seq, 4, in_shape, layout)
    assert shapes[0] == ((2, 4, 7) if layout == "NTC" else (4, 2, 7))

    def bi(mx):
        return mx.rnn.BidirectionalCell(mx.rnn.RNNCell(4, prefix="fw_"),
                                        mx.rnn.GRUCell(4, prefix="bw_"))
    shapes = _run_cells(bi, 3, in_shape[:2] + (5,), layout, seed=22)
    assert shapes[0][-1] == 8
    for mx in SIDES:
        with pytest.raises((JError, TError)):
            bi(mx)(mx.sym.var("x"), [])


def test_bidirectional_begin_state_forwarded():
    def run(mx):
        bi = mx.rnn.BidirectionalCell(mx.rnn.RNNCell(3, prefix="fw_"),
                                      mx.rnn.RNNCell(3, prefix="bw_"))
        outs, _ = bi.unroll(2, mx.sym.var("data"),
                            begin_state=[mx.sym.var("fw_h0"),
                                         mx.sym.var("bw_h0")],
                            merge_outputs=True)
        return outs.list_arguments()
    ja, ta = _both(run)
    assert ja == ta and "fw_h0" in ta and "bw_h0" in ta


# -- mx.viz ---------------------------------------------------------------------
def test_viz_print_summary_and_dot(capsys):
    def run(mx):
        sym = mx.sym
        out = sym.softmax(sym.FullyConnected(
            sym.var("data"), sym.var("fc_weight"), sym.var("fc_bias"),
            num_hidden=10, name="fc1"), name="sm1")
        total = mx.viz.print_summary(out, shape={"data": (1, 20)})
        return total, capsys.readouterr().out, mx.viz.plot_network(out)
    (jt, jp, jd), (tt, tp, td) = _both(run)
    assert jt == tt == 20 * 10 + 10
    assert jp == tp and "Total params: 210" in tp

    def ids(dot):  # node ids are object addresses: number them in order
        seen = {}
        return re.sub(r"n\d+", lambda m: seen.setdefault(
            m.group(0), f"n{len(seen)}"), dot)
    assert ids(jd) == ids(td) and "FullyConnected" in td


# -- mx.operator -----------------------------------------------------------------
def _register(mx):
    """The JAX test's ``Sigmoid``, a multi-output ``SplitHalf``, a square
    (for ``sym.Custom``) and a deliberately wrong backward, registered
    under names of their own in ``mx``."""
    tag = mx.__name__
    nd = mx.nd

    class Sigmoid(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], 1.0 / (1.0 + nd.exp(-in_data[0])))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1.0 - y))

    class SplitHalf(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            n = x.shape[0] // 2
            self.assign(out_data[0], req[0], x[:n])
            self.assign(out_data[1], req[1], x[n:])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        nd.concat(out_grad[0], out_grad[1], dim=0))

    class Sq(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], 2 * in_data[0] * out_grad[0])

    class Fake(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 2.0)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * 100.0)

    def prop(op_cls, outputs=("output",), shapes=None):
        class Prop(mx.operator.CustomOpProp):
            def list_outputs(self):
                return list(outputs)

            def infer_shape(self, in_shape):
                if shapes is None:
                    return in_shape, [in_shape[0]], []
                return in_shape, shapes(in_shape[0]), []

            def create_operator(self, ctx, shapes_, dtypes):
                return op_cls()
        return Prop

    mx.operator.register(f"sigmoid_{tag}")(prop(Sigmoid))
    mx.operator.register(f"split_{tag}")(prop(
        SplitHalf, ("top", "bottom"),
        lambda s: [[s[0] // 2, s[1]], [s[0] - s[0] // 2, s[1]]]))
    mx.operator.register(f"sq_{tag}")(prop(Sq))
    mx.operator.register(f"fake_{tag}")(prop(Fake))


for _mx in SIDES:
    _register(_mx)


def test_custom_op_forward_backward_and_user_backward():
    x0 = np.random.RandomState(23).uniform(-2, 2, (3, 4)).astype(np.float32)

    def run(mx):
        a = mx.nd.array(x0)
        a.attach_grad()
        with mx.autograd.record():
            y = mx.nd.Custom(a, op_type=f"sigmoid_{mx.__name__}")
            loss = (y * y).sum()
        loss.backward()
        b = mx.nd.array(x0)
        b.attach_grad()
        with mx.autograd.record():
            z = mx.nd.Custom(b, op_type=f"fake_{mx.__name__}")
        z.backward()
        return y, a.grad, z, b.grad
    (jy, jg, jz, jb), (ty, tg, tz, tb) = _both(run)
    _close([jy, jz], [ty, tz])
    _close([jg, jb], [tg, tb], GRAD)
    s = 1 / (1 + np.exp(-x0))
    np.testing.assert_allclose(_np(tg), 2 * s * s * (1 - s), **GRAD)
    # the user's backward defines the gradient, not autograd of forward
    np.testing.assert_allclose(_np(tb), 100.0, **GRAD)


def test_custom_op_multi_output():
    x0 = np.arange(12, dtype=np.float32).reshape(4, 3)

    def run(mx):
        a = mx.nd.array(x0)
        a.attach_grad()
        with mx.autograd.record():
            top, bot = mx.nd.Custom(a, op_type=f"split_{mx.__name__}")
            loss = (top * 2).sum() + (bot * 3).sum()
        loss.backward()
        return top, bot, a.grad
    j, t = _both(run)
    _close(j, t)
    np.testing.assert_allclose(_np(t[2]), np.repeat([2.0, 3.0], 2)[:, None]
                               * np.ones((4, 3)))


def test_custom_op_in_step_graph():
    """A CustomOp of nd ops with no host read is a step of a StepGraph
    (JAX: under jit); on the CPU the graph runs its step eagerly."""
    from mxnet_tpu_torch.ops.cuda_graph import StepGraph

    x0 = np.random.RandomState(24).uniform(-1, 1, (4,)).astype(np.float32)
    fn, nout = tmx.operator.make_custom_fn("sigmoid_mxnet_tpu_torch", {})
    jfn, _ = jmx.operator.make_custom_fn("sigmoid_mxnet_tpu", {})
    x = torch.from_numpy(x0)
    g = StepGraph(lambda: (fn(x),), ("custom",), x.device)
    (out,) = g()
    assert nout == 1
    np.testing.assert_allclose(out.numpy(), np.asarray(jfn(x0)), **FWD)


def test_custom_op_unregistered():
    for mx, err in ((jmx, JError), (tmx, TError)):
        with tmx.cpu(), pytest.raises(err, match="not registered"):
            mx.nd.Custom(mx.nd.zeros((2,)), op_type="nope_not_registered")


# -- Parameter.var() ---------------------------------------------------------------
def test_parameter_var_is_the_symbol_variable(name_counters):  # noqa: F811
    """``Parameter.var()`` is the parameter's Symbol variable (named as the
    parameter, made once), as in the JAX package; the torch parameter is
    ``Parameter.tensor()``."""
    with tmx.cpu():
        d = tmx.gluon.nn.Dense(3, in_units=2)
        d.initialize()
    p = d.collect_params()[d.prefix + "weight"]
    v = p.var()
    assert isinstance(v, tmx.sym.Symbol) and v.name == p.name
    assert p.var() is v and v.list_arguments() == [p.name]
    assert p.tensor() is d.weight
    jd = jmx.gluon.nn.Dense(3, in_units=2)
    jp = jd.collect_params()[jd.prefix + "weight"]
    assert isinstance(jp.var(), jmx.sym.Symbol)
