"""The port's recurrent nets against the JAX package's on the same seeded
numpy inputs:

- the fused ``RNN`` op (``ops/nn.py``) in its four modes, one and two
  layers, one and two directions, with and without ``state_cell``: values
  and the gradients of the data, the flat parameters and the states;
- the GRU's ``b_hn``. The port follows MXNet and cuDNN, ``n = tanh(x W_n +
  b_xn + r * (h W_hn + b_hn))``, as the JAX package's own ``GRUCell`` does;
  the JAX fused op adds ``b_hn`` outside the reset gate. So the fused GRU
  is held to the JAX op at ``b_hn = 0`` (where only the gradient of
  ``b_hn`` itself differs, ``r * dn`` against ``dn``, which the test shows),
  and at a nonzero ``b_hn`` to an unrolled ``GRUCell`` (in both packages),
  while the JAX op is shown to differ there; the ``b_hn`` gradients, and at
  a nonzero ``b_hn`` every gradient, are held to ``torch.nn.GRU`` on the
  CPU (MXNet's formula) and, for one layer, to the JAX ``GRUCell``'s;
- the Gluon layers ``LSTM``, ``GRU`` and ``RNN`` loading ``.params``
  files the JAX package saved (both layouts, with and without states,
  dropout between layers in predict mode), and deferred shapes;
- every cell and modifier through ``unroll``, with and without
  ``valid_length``, after loading the JAX cells' ``.params``;
- the fused LSTM equal to an unrolled ``LSTMCell`` on the same weights.

Shapes stay tiny (T 5, B 3, H 6). Tolerance: f32 1e-5 relative, 1e-5
absolute for values and gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.ops import nn as tnn

TOL = dict(rtol=1e-5, atol=1e-5)
T, B, C, H = 5, 3, 4, 6
GATES = {"lstm": 4, "gru": 3, "rnn_tanh": 1, "rnn_relu": 1}


def _f(shape, seed, scale=0.5):
    return (np.random.RandomState(seed).uniform(-1, 1, shape) * scale
            ).astype(np.float32)


def _flat(mode, layers, bidir, seed, zero_bhn=False):
    """Seeded flat parameters; with ``zero_bhn`` the GRU's b_hn is 0."""
    n = tnn.rnn_param_size(mode, C, H, layers, bidir)
    p = _f((n,), seed)
    if zero_bhn:
        g = GATES[mode] * H
        nb = layers * (2 if bidir else 1)
        bias = p[n - 2 * g * nb:].reshape(nb, 2, g)
        bias[:, 1, 2 * H:] = 0.0
    return p


CASES = [("lstm", 1, False, True), ("lstm", 2, True, True),
         ("lstm", 2, False, False), ("gru", 2, True, False),
         ("rnn_tanh", 2, False, False), ("rnn_relu", 1, True, False)]


def _bhn_slots(mode, layers, bidir):
    """The positions of every b_hn in the flat vector of a GRU."""
    if mode != "gru":
        return np.zeros(0, np.int64)
    n = tnn.rnn_param_size(mode, C, H, layers, bidir)
    g, nb = 3 * H, layers * (2 if bidir else 1)
    start = n - 2 * g * nb
    return np.concatenate([start + k * 2 * g + g + np.arange(2 * H, 3 * H)
                           for k in range(nb)])


@pytest.mark.parametrize("mode,layers,bidir,cell", CASES,
                         ids=[f"{m}-L{n}-{'bi' if b else 'uni'}"
                              f"{'-cell' if c else ''}"
                              for m, n, b, c in CASES])
def test_rnn_op_matches_jax(mode, layers, bidir, cell):
    d = 2 if bidir else 1
    x = _f((T, B, C), 1, 1.0)
    p = _flat(mode, layers, bidir, 2, zero_bhn=mode == "gru")
    h0 = _f((layers * d, B, H), 3)
    c0 = _f((layers * d, B, H), 4) if cell else None
    kw = dict(state_size=H, num_layers=layers, mode=mode,
              bidirectional=bidir)
    args = [x, p, h0] + ([c0] if cell else [])

    def jf(*a):
        return jnn.rnn(a[0], a[1], a[2], a[3] if cell else None, **kw)

    jout, vjp = jax.vjp(jax.jit(jf), *[jnp.asarray(a) for a in args])
    t_in = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
    tout = tnn.rnn(t_in[0], t_in[1], t_in[2], t_in[3] if cell else None,
                   **kw)
    for g, w in zip(tout, jout):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    cots = [_f(o.shape, 10 + k, 1.0) for k, o in enumerate(jout)]
    n = 3 if mode == "lstm" else 2  # c_n is zeros but for the LSTM
    cots[n:] = [np.zeros_like(c) for c in cots[n:]]
    jg = vjp(tuple(jnp.asarray(c) for c in cots))
    torch.autograd.backward(list(tout[:n]),
                            [torch.from_numpy(c) for c in cots[:n]])
    grads = [np.asarray(g).copy() for g in jg]
    # the GRU's b_hn: its value is 0 here, where the two formulas agree,
    # but its gradient is r * dn in MXNet's (the port) and dn in the JAX op;
    # those slots are held to torch.nn.GRU's (MXNet's formula) instead
    bhn = _bhn_slots(mode, layers, bidir)
    if bhn.size:
        assert np.abs(t_in[1].grad.numpy()[bhn] - grads[1][bhn]).max() > 1e-3
        lib = _library_gru_grads(layers, bidir, args[:3], cots[:2])
        grads[1][bhn] = lib[1][bhn]
    for t, g in zip(t_in, grads):
        np.testing.assert_allclose(t.grad.numpy(), g, **TOL)


def _library_gru_grads(layers, bidir, args, cots):
    """torch.nn.GRU on the CPU (MXNet's and cuDNN's formula) holding the
    flat parameters, read here in the reference's layout (every layer's
    and direction's W_x, W_h, then every b_x, b_h): the outputs and the
    gradients of the data, the flat vector and h0 under the cotangents of
    the output and h_n."""
    x, p, h0 = args
    d, g = (2 if bidir else 1), 3 * H
    lib = torch.nn.GRU(C, H, num_layers=layers, bidirectional=bidir)
    names = [(f"{kind}_{m}_l{layer}{'_reverse' if k else ''}", shape)
             for kind in ("weight", "bias") for layer in range(layers)
             for k in range(d) for m, shape in
             (("ih", (g, C if layer == 0 else H * d) if kind == "weight"
               else (g,)), ("hh", (g, H) if kind == "weight" else (g,)))]
    off = 0
    with torch.no_grad():
        for name, shape in names:
            n = int(np.prod(shape))
            getattr(lib, name).copy_(torch.from_numpy(
                p[off:off + n].reshape(shape)))
            off += n
    assert off == p.size
    xl, hl = (torch.from_numpy(a.copy()).requires_grad_() for a in (x, h0))
    outs = lib(xl, hl)
    torch.autograd.backward(list(outs), [torch.from_numpy(c) for c in cots])
    flat = np.concatenate([getattr(lib, name).grad.numpy().ravel()
                           for name, _ in names])
    return (xl.grad.numpy(), flat, hl.grad.numpy(),
            [o.detach().numpy() for o in outs])


def _gru_cell_unroll(pkg, p, x, h0, cots=None):
    """One-layer GRUCell of the package ``pkg`` over ``x`` (T, B, C) with
    the flat parameters ``p`` (W_x, W_h, b_x, b_h): the output and h_n,
    and with ``cots`` (the output's and h_n's cotangents) the gradients of
    the data, the flat vector (from the cell's four weights) and h0, under
    the package's autograd."""
    g, nd = 3 * H, pkg.nd
    cell = pkg.gluon.rnn.GRUCell(H, input_size=C)
    cell.initialize()
    parts = (p[:g * C].reshape(g, C), p[g * C:g * C + g * H].reshape(g, H),
             p[-2 * g:-g], p[-g:])
    params = [cell.collect_params()[cell.prefix + n] for n in
              ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias")]
    for prm, v in zip(params, parts):
        prm.set_data(nd.array(v))
    jx, jh = nd.array(x), nd.array(h0)
    if cots is None:
        out, states = cell.unroll(T, jx, [jh], layout="TNC")
        return out.asnumpy(), states[0].asnumpy()
    jx.attach_grad()
    jh.attach_grad()
    with pkg.autograd.record():
        out, states = cell.unroll(T, jx, [jh], layout="TNC")
        obj = (out * nd.array(cots[0])).sum() + \
            (states[0] * nd.array(cots[1][0])).sum()
    obj.backward()
    flat = np.concatenate([prm.grad().asnumpy().ravel() for prm in params])
    return (out.asnumpy(), states[0].asnumpy(), jx.grad.asnumpy(), flat,
            jh.grad.asnumpy())


def test_fused_gru_follows_mxnet_b_hn_not_the_jax_op():
    """At a nonzero b_hn the port's fused GRU equals an unrolled GRUCell of
    either package (MXNet's formula), with the JAX cell's gradients of the
    data, of every flat parameter and of h0 under its autograd; the JAX
    fused op, which puts b_hn outside the reset gate, differs from both."""
    x = _f((T, B, C), 5, 1.0)
    p = _flat("gru", 1, False, 6)
    h0 = _f((1, B, H), 7)
    cots = [_f((T, B, H), 19, 1.0), _f((1, B, H), 20, 1.0)]
    assert np.abs(p[_bhn_slots("gru", 1, False)]).min() > 0
    t_in = [torch.from_numpy(a.copy()).requires_grad_() for a in (x, p, h0)]
    port = tnn.rnn(*t_in, state_size=H, mode="gru")[:2]
    torch.autograd.backward(list(port), [torch.from_numpy(c) for c in cots])
    jax_op = jnn.rnn(jnp.asarray(x), jnp.asarray(p), jnp.asarray(h0),
                     state_size=H, mode="gru")
    with tmx.cpu():
        t_out, t_h = _gru_cell_unroll(tmx, p, x, h0[0])
    j_out, j_h, *j_grads = _gru_cell_unroll(jmx, p, x, h0[0], cots)
    np.testing.assert_allclose(port[0].detach().numpy(), t_out, **TOL)
    np.testing.assert_allclose(port[0].detach().numpy(), j_out, **TOL)
    np.testing.assert_allclose(port[1][0].detach().numpy(), j_h, **TOL)
    np.testing.assert_allclose(t_h, j_h, **TOL)
    for t, w in zip(t_in, j_grads):
        np.testing.assert_allclose(t.grad.numpy().reshape(w.shape), w, **TOL)
    assert np.abs(np.asarray(jax_op[0]) - j_out).max() > 1e-2


GRU_GRAD_CASES = [(1, False), (2, True)]


@pytest.mark.parametrize("layers,bidir", GRU_GRAD_CASES,
                         ids=[f"L{n}-{'bi' if b else 'uni'}"
                              for n, b in GRU_GRAD_CASES])
def test_fused_gru_gradients_at_nonzero_b_hn(layers, bidir):
    """At a nonzero b_hn (MXNet's formula, where the JAX fused op differs)
    the port's fused GRU has torch.nn.GRU's outputs and gradients of the
    data, of every flat parameter and of h0 on the CPU."""
    d = 2 if bidir else 1
    x = _f((T, B, C), 16, 1.0)
    p = _flat("gru", layers, bidir, 17)
    h0 = _f((layers * d, B, H), 18)
    cots = [_f((T, B, H * d), 19, 1.0), _f((layers * d, B, H), 20, 1.0)]
    assert np.abs(p[_bhn_slots("gru", layers, bidir)]).min() > 0
    t_in = [torch.from_numpy(a.copy()).requires_grad_() for a in (x, p, h0)]
    tout = tnn.rnn(*t_in, state_size=H, num_layers=layers, mode="gru",
                   bidirectional=bidir)[:2]  # c_n is zeros
    torch.autograd.backward(list(tout), [torch.from_numpy(c) for c in cots])
    *want, outs = _library_gru_grads(layers, bidir, (x, p, h0), cots)
    for g, w in zip(tout, outs):
        np.testing.assert_allclose(g.detach().numpy(), w, **TOL)
    for t, w in zip(t_in, want):
        np.testing.assert_allclose(t.grad.numpy(), w, **TOL)


def test_rnn_op_dropout_between_layers():
    """p > 0 under training drops the first layer's output (the port's
    generator); the last layer is never dropped, and p = 0 or predict mode
    is the plain op."""
    x = torch.from_numpy(_f((T, B, C), 8, 1.0))
    p = torch.from_numpy(_flat("rnn_relu", 2, False, 9))
    h0 = torch.zeros(2, B, H)
    kw = dict(state_size=H, num_layers=2, mode="rnn_relu")
    plain = tnn.rnn(x, p, h0, **kw)[0]
    np.testing.assert_array_equal(
        tnn.rnn(x, p, h0, p=0.5, **kw)[0].numpy(), plain.numpy())
    gen = torch.Generator().manual_seed(0)
    dropped = tnn.rnn(x, p, h0, p=0.5, training=True, key=gen, **kw)[0]
    assert not torch.equal(dropped, plain)


def _save_jax(block, tmp_path, name):
    path = str(tmp_path / f"{name}.params")
    block.save_parameters(path)
    return path


LAYERS = [("LSTM", {}, "TNC", True), ("LSTM", {"bidirectional": True,
                                              "dropout": 0.3}, "NTC", False),
          ("RNN", {"activation": "tanh"}, "TNC", True),
          ("GRU", {}, "NTC", True)]


@pytest.mark.parametrize("cls,kw,layout,states", LAYERS,
                         ids=[f"{c}-{l}-{'states' if s else 'nostates'}"
                              for c, _, l, s in LAYERS])
def test_gluon_layer_loads_jax_params(cls, kw, layout, states, tmp_path):
    """A JAX layer's .params file (rnn_param, structural name
    ``parameters``) loads into the port's layer; outputs and states agree
    (the GRU's b_hn zeroed, where the two packages' fused GRUs agree)."""
    jl = getattr(jrnn, cls)(H, num_layers=2, layout=layout, **kw)
    jl.initialize(jmx.init.Uniform(0.3))
    x = _f((T, B, C) if layout == "TNC" else (B, T, C), 11, 1.0)
    jl(jnd.array(x))  # resolve the deferred shape
    if cls == "GRU":
        d = 2 if kw.get("bidirectional") else 1
        flat = jl.params[jl.prefix + "rnn_param"].data().asnumpy().copy()
        bias = flat[len(flat) - 2 * 3 * H * 2 * d:].reshape(2 * d, 2, 3 * H)
        bias[:, 1, 2 * H:] = 0.0
        jl.params[jl.prefix + "rnn_param"].set_data(jnd.array(flat))
    path = _save_jax(jl, tmp_path, cls)
    with tmx.cpu():
        tl = getattr(trnn, cls)(H, num_layers=2, layout=layout, **kw)
        tl.initialize()
        tl(tnd.array(x))
        tl.load_parameters(path)
        assert list(tl._collect_params_with_prefix()) == ["parameters"]
        if states:
            s0 = [_f(i["shape"], 12 + k) for k, i in
                  enumerate(jl.state_info(B))]
            got = tl(tnd.array(x), [tnd.array(s) for s in s0])
            want = jl(jnd.array(x), [jnd.array(s) for s in s0])
            np.testing.assert_allclose(got[0].asnumpy(), want[0].asnumpy(),
                                       **TOL)
            for g, w in zip(got[1], want[1]):
                np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), **TOL)
        else:
            got, want = tl(tnd.array(x)), jl(jnd.array(x))
            np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)
        begin = tl.begin_state(B)
        assert [tuple(s.shape) for s in begin] == \
            [i["shape"] for i in tl.state_info(B)]
        assert begin[0].context == tmx.cpu()


def _cells(pkg):
    """name -> a cell of ``pkg``'s gluon.rnn (input size C)."""
    r = pkg.gluon.rnn

    def seq():
        s = r.SequentialRNNCell()
        s.add(r.LSTMCell(H, input_size=C))
        s.add(r.GRUCell(H, input_size=H))
        return s

    return {
        "RNNCell": lambda: r.RNNCell(H, activation="relu", input_size=C),
        "LSTMCell": lambda: r.LSTMCell(H, input_size=C),
        "GRUCell": lambda: r.GRUCell(H, input_size=C),
        "SequentialRNNCell": seq,
        "ResidualCell": lambda: r.ResidualCell(r.GRUCell(C, input_size=C)),
        "DropoutCell": lambda: r.DropoutCell(r.LSTMCell(H, input_size=C),
                                             rate=0.5),
        "ZoneoutCell": lambda: r.ZoneoutCell(r.RNNCell(H, input_size=C),
                                             0.3, 0.3),
        "BidirectionalCell": lambda: r.BidirectionalCell(
            r.LSTMCell(H, input_size=C), r.GRUCell(H, input_size=C)),
    }


def _flat_states(s):
    if isinstance(s, (list, tuple)):
        return [x for v in s for x in _flat_states(v)]
    return [s.asnumpy()]


# (name, with valid_length); the JAX unroll cannot stack a
# SequentialRNNCell's nested states under valid_length
CELL_CASES = [(n, v) for n in sorted(_cells(jmx)) for v in (False, True)
              if not (n == "SequentialRNNCell" and v)]


@pytest.mark.parametrize("name,valid", CELL_CASES,
                         ids=[f"{n}-{'valid' if v else 'full'}"
                              for n, v in CELL_CASES])
def test_cell_unroll_matches_jax(name, valid, tmp_path):
    x = _f((B, T, C), 13, 1.0)
    lens = np.array([5, 2, 3], np.float32)
    jc = _cells(jmx)[name]()
    jc.initialize(jmx.init.Uniform(0.4))
    kw = dict(valid_length=jnd.array(lens)) if valid else {}
    want = jc.unroll(T, jnd.array(x), layout="NTC", **kw)
    path = _save_jax(jc, tmp_path, name)
    with tmx.cpu():
        tc = _cells(tmx)[name]()
        tc.initialize()
        tc.load_parameters(path)
        kw = dict(valid_length=tnd.array(lens)) if valid else {}
        got = tc.unroll(T, tnd.array(x), layout="NTC", **kw)
    np.testing.assert_allclose(got[0].asnumpy(), want[0].asnumpy(), **TOL)
    for g, w in zip(_flat_states(got[1]), _flat_states(want[1])):
        np.testing.assert_allclose(g, w, **TOL)


def test_cell_list_outputs_and_training_modifiers():
    """``merge_outputs=False`` gives one output a step; in training the
    dropout cell zeroes and rescales, the zoneout cell keeps some of the
    previous values; BidirectionalCell refuses a single step."""
    with tmx.cpu():
        x = tnd.array(_f((B, T, C), 14, 1.0))
        cell = trnn.LSTMCell(H, input_size=C)
        cell.initialize()
        outs, _ = cell.unroll(T, x, merge_outputs=False)
        merged, _ = cell.unroll(T, x)
        assert len(outs) == T
        np.testing.assert_allclose(outs[2].asnumpy(),
                                   merged.asnumpy()[:, 2], **TOL)
        drop = trnn.DropoutCell(cell, rate=0.5)
        with tmx.autograd.record():
            out, _ = drop.unroll(T, x)
        plain = merged.asnumpy()
        got = out.asnumpy()
        zero = got == 0
        assert zero.any() and (~zero).any()
        np.testing.assert_allclose(got[~zero], 2 * plain[~zero], **TOL)
        bi = trnn.BidirectionalCell(trnn.LSTMCell(H), trnn.LSTMCell(H))
        with pytest.raises(NotImplementedError):
            bi(x, bi.begin_state(B))


def test_fused_lstm_equals_unrolled_lstm_cells():
    """Two fused LSTM layers equal two LSTMCells (SequentialRNNCell) on the
    same weights, outputs and final states."""
    with tmx.cpu():
        layer = trnn.LSTM(H, num_layers=2, input_size=C)
        layer.initialize(tmx.init.Uniform(0.4))
        flat = layer._reg_params["parameters"].data().asnumpy()
        seq = trnn.SequentialRNNCell()
        seq.add(trnn.LSTMCell(H, input_size=C))
        seq.add(trnn.LSTMCell(H, input_size=H))
        seq.initialize()
        g, off = 4 * H, 0
        cells = list(seq._children.values())
        for cell, ind in zip(cells, (C, H)):
            for name, n, shape in (("i2h_weight", g * ind, (g, ind)),
                                   ("h2h_weight", g * H, (g, H))):
                cell._reg_params[name].set_data(
                    flat[off:off + n].reshape(shape))
                off += n
        for cell in cells:
            for name in ("i2h_bias", "h2h_bias"):
                cell._reg_params[name].set_data(flat[off:off + g])
                off += g
        assert off == flat.size
        x = tnd.array(_f((T, B, C), 15, 1.0))
        out, (h, c) = layer(x, layer.begin_state(B))
        cout, cstates = seq.unroll(T, x, layout="TNC")
    np.testing.assert_allclose(out.asnumpy(), cout.asnumpy(), **TOL)
    np.testing.assert_allclose(h.asnumpy()[1], cstates[1][0].asnumpy(),
                               **TOL)
    np.testing.assert_allclose(c.asnumpy()[0], cstates[0][1].asnumpy(),
                               **TOL)
