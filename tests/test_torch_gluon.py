"""The port's Gluon (Parameter, ParameterDict, Block/HybridBlock, the basic
layers, the model zoo rebased on HybridBlock) against the JAX package's:
``collect_params`` keys and structural names for an MLP, GPT-2 (2 layers,
128 units) and BERT (2 layers), deferred init and ``select=``, ``.params``
files both ways with equal outputs and the load error paths,
``hybridize`` equivalence and a user ``hybrid_forward`` block, Dropout
under ``record(train_mode=...)``, and ``hybridize(remat=True)`` gradients
equal to the ones without it."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models import bert as jbert
from mxnet_tpu.models import gpt2 as jgpt2
from mxnet_tpu_torch.models import bert as tbert
from mxnet_tpu_torch.models import gpt2 as tgpt2

F32 = dict(rtol=1e-5, atol=1e-6)
# a whole model's forward (the two packages sum in different orders)
MODEL = dict(rtol=1e-4, atol=1e-4)
GPT2 = dict(num_layers=2, units=128, num_heads=2, max_length=64,
            vocab_size=97, dropout=0.0)
BERT = dict(num_layers=2, units=64, hidden_size=128, num_heads=2,
            max_length=32, vocab_size=50, dropout=0.0)


def _mlp(mx, prefix="mlp_", in_units=0):
    net = mx.gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(8, activation="relu", in_units=in_units),
                mx.gluon.nn.Dense(3, in_units=8 if in_units else 0))
    return net


def _carry(jnet, tnet):
    """The JAX net's values into the port's, by structural name."""
    tparams = tnet._collect_params_with_prefix()
    for name, p in jnet._collect_params_with_prefix().items():
        tparams[name].set_data(p.data().asnumpy())


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _names(net):
    return list(net.collect_params().keys()), \
        list(net._collect_params_with_prefix().keys())


def test_mlp_names_match_jax():
    jnet = _mlp(jmx, in_units=5)
    with tmx.cpu():
        tnet = _mlp(tmx, in_units=5)
    assert _names(tnet) == _names(jnet)
    assert list(tnet.state_dict()) == _names(jnet)[1]
    assert _names(jnet)[0] == ["mlp_dense0_weight", "mlp_dense0_bias",
                               "mlp_dense1_weight", "mlp_dense1_bias"]


def test_gpt2_names_match_jax():
    jnet = jgpt2.GPT2Model(prefix="g_", **GPT2)
    tnet = tgpt2.GPT2Model(prefix="g_", device="cpu", **GPT2)
    assert _names(tnet) == _names(jnet)
    assert list(tnet.state_dict()) == _names(jnet)[1]
    # the tied LM head adds no parameter: one Trainer state for it
    assert "g_word_embed_weight" in tnet.collect_params()
    assert len(tnet.collect_params()) == len(list(tnet.parameters()))


def test_bert_names_match_jax():
    jb = jbert.BERTModel(prefix="b_", **BERT)
    jnet = jbert.BERTForPretrain(jb, vocab_size=BERT["vocab_size"],
                                 prefix="p_")
    tb = tbert.BERTModel(prefix="b_", device="cpu", **BERT)
    tnet = tbert.BERTForPretrain(tb, vocab_size=BERT["vocab_size"],
                                 prefix="p_")
    assert _names(tnet) == _names(jnet)
    assert _names(tb) == _names(jb)
    assert list(tnet.state_dict()) == _names(jnet)[1]


def test_deferred_init_and_select_match_jax():
    jmx.random.seed(0)
    jnet = _mlp(jmx)
    jnet.initialize()
    with tmx.cpu():
        tnet = _mlp(tmx)
        tnet.initialize()
    for net, mx in ((jnet, jmx), (tnet, tmx)):
        w = net.collect_params()["mlp_dense0_weight"]
        with pytest.raises(mx.gluon.parameter.DeferredInitializationError):
            w.data()
    x = _x((4, 6))
    jout = jnet(jmx.nd.array(x))
    with tmx.cpu():
        tnet(tmx.nd.array(x))
    assert tnet.collect_params()["mlp_dense0_weight"].shape == (8, 6)
    _carry(jnet, tnet)
    np.testing.assert_allclose(tnet(tmx.nd.array(x, ctx=tmx.cpu()))
                               .asnumpy(), jout.asnumpy(), **F32)
    for sel in ("mlp_dense1_.*", ".*bias"):
        assert list(tnet.collect_params(sel).keys()) == \
            list(jnet.collect_params(sel).keys())


def test_params_files_cross_both_ways(tmp_path):
    """A .params file from either package loads into the other's MLP and
    GPT-2, and both give the same outputs."""
    jmx.random.seed(1)
    jnet = _mlp(jmx, in_units=6)
    jnet.initialize()
    with tmx.cpu():
        tnet = _mlp(tmx, in_units=6)
    x = _x((4, 6), 1)
    f = str(tmp_path / "jax.params")
    jnet.save_parameters(f)
    tnet.load_parameters(f)
    np.testing.assert_allclose(tnet(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy(),
                               jnet(jmx.nd.array(x)).asnumpy(), **F32)
    with torch.no_grad():
        for p in tnet.parameters():
            p.mul_(-0.5)
    g = str(tmp_path / "port.params")
    tnet.save_parameters(g)
    jnet.load_parameters(g)
    np.testing.assert_allclose(jnet(jmx.nd.array(x)).asnumpy(),
                               tnet(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy(),
                               **F32)

    jmx.random.seed(2)
    jg = jgpt2.GPT2Model(**GPT2)
    jg.initialize()
    ids = np.random.RandomState(3).randint(0, GPT2["vocab_size"], (2, 9))
    jlogits = jg(jmx.nd.array(ids, dtype="int32")).asnumpy()
    f = str(tmp_path / "gpt2.params")
    jg.save_parameters(f)
    tg = tgpt2.get_gpt2("gpt2_tiny", ctx=tmx.cpu(), seed=5,
                        **{k: v for k, v in GPT2.items() if k != "dropout"})
    tg.load_parameters(f)
    tids = tmx.nd.array(ids, ctx=tmx.cpu())
    np.testing.assert_allclose(tg(tids).asnumpy(), jlogits, **MODEL)
    with torch.no_grad():
        tg.ln_f.gamma.mul_(1.5)
    tg.save_parameters(f)
    jg.load_parameters(f)
    np.testing.assert_allclose(jg(jmx.nd.array(ids, dtype="int32")).asnumpy(),
                               tg(tids).asnumpy(), **MODEL)


def test_bf16_params_keep_their_dtype_and_cast_dtype(tmp_path):
    """bfloat16 parameters are saved as bfloat16; a float32 net loads them
    cast to float32, or takes bf16 with cast_dtype and dtype_source
    'saved'."""
    with tmx.cpu():
        a = _mlp(tmx, in_units=4)
        a.initialize()
        a.cast("bfloat16")
        f = str(tmp_path / "bf16.params")
        a.save_parameters(f)
        b = _mlp(tmx, in_units=4)
        b.load_parameters(f)
        c = _mlp(tmx, in_units=4)
        c.load_parameters(f, cast_dtype=True, dtype_source="saved")
    assert b[0].weight.dtype == torch.float32
    assert c[0].weight.dtype == torch.bfloat16
    assert torch.equal(c[0].weight, a[0].weight)
    assert torch.equal(b[0].weight, a[0].weight.float())
    loaded = jmx.nd.load(f)
    assert str(loaded["0.weight"].dtype) == "bfloat16"


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_load_parameters_error_paths(tmp_path, side):
    """Missing parameters raise unless allow_missing; extra ones raise
    unless ignore_extra (tests/test_gluon.py's case, in each package)."""
    mx = {"jax": jmx, "torch": tmx}[side]
    ctx = tmx.cpu() if side == "torch" else jmx.cpu()
    with ctx:
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(3, in_units=2, prefix="lp_"))
        net.initialize()
        f = str(tmp_path / "full.params")
        net.save_parameters(f)
        bigger = mx.gluon.nn.HybridSequential()
        bigger.add(mx.gluon.nn.Dense(3, in_units=2, prefix="lp_"),
                   mx.gluon.nn.Dense(1, prefix="x_"))
        bigger.initialize()
        _ = bigger(mx.nd.ones((1, 2)))
        with pytest.raises(mx.MXNetError, match="missing"):
            bigger.load_parameters(f)
        bigger.load_parameters(f, allow_missing=True)
        f2 = str(tmp_path / "big.params")
        bigger.save_parameters(f2)
        with pytest.raises(mx.MXNetError, match="unknown"):
            net.load_parameters(f2)
        net.load_parameters(f2, ignore_extra=True)


class _Scaled:
    """A user block written against either package's HybridBlock:
    ``y = tanh(x @ w.T) * scale + b`` with a declared parameter."""

    @staticmethod
    def make(mx):
        class Scaled(mx.gluon.HybridBlock):
            def __init__(self, units, in_units, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.w = self.params.get("w", shape=(units, in_units))
                    self.b = self.params.get("b", shape=(units,),
                                             init="zeros")

            def hybrid_forward(self, F, x, w, b):
                y = F.dot(x, w, transpose_b=True)
                return F.broadcast_add(F.tanh(y) * 1.5, b)

        return Scaled


@pytest.mark.parametrize("hybridize", [False, True])
def test_user_hybrid_forward_block_matches_jax(hybridize):
    jmx.random.seed(3)
    jblk = _Scaled.make(jmx)(4, 5, prefix="s_")
    jblk.initialize()
    with tmx.cpu():
        tblk = _Scaled.make(tmx)(4, 5, prefix="s_")
        tblk.initialize()
    assert list(tblk.collect_params().keys()) == ["s_w", "s_b"]
    _carry(jblk, tblk)
    if hybridize:
        jblk.hybridize()
        tblk.hybridize()
    x = _x((3, 5), 4)
    grads = []
    for blk, mx in ((jblk, jmx), (tblk, tmx)):
        with (tmx.cpu() if mx is tmx else jmx.cpu()):
            xa = mx.nd.array(x)
            with mx.autograd.record():
                out = blk(xa)
                loss = (out * out).sum()
            loss.backward()
        grads.append([out.asnumpy()] +
                     [p.grad().asnumpy() for p in blk.collect_params()
                      .values()])
    for g, w in zip(grads[1], grads[0]):
        np.testing.assert_allclose(g, w, **F32)


def test_hybridize_keeps_eager_results():
    """hybridize() changes nothing in the port's results (it compiles
    nothing) for a GPT-2."""
    net = tgpt2.GPT2Model(device="cpu", seed=1, **GPT2)
    ids = tmx.nd.array(np.random.RandomState(0).randint(0, 97, (2, 7)),
                       ctx=tmx.cpu())
    before = net(ids).asnumpy()
    net.hybridize()
    np.testing.assert_array_equal(net(ids).asnumpy(), before)


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_dropout_follows_record_train_mode(side):
    """Dropout is active under record() (train mode) and not under
    record(train_mode=False) or outside record, in either package."""
    mx = {"jax": jmx, "torch": tmx}[side]
    with (tmx.cpu() if side == "torch" else jmx.cpu()):
        drop = mx.gluon.nn.Dropout(0.5)
        x = mx.nd.ones((400,))
        with mx.autograd.record():
            train = drop(x).asnumpy()
        with mx.autograd.record(train_mode=False):
            frozen = drop(x).asnumpy()
        outside = drop(x).asnumpy()
    np.testing.assert_array_equal(frozen, np.ones(400, np.float32))
    np.testing.assert_array_equal(outside, np.ones(400, np.float32))
    assert set(np.unique(train)) <= {0.0, 2.0}
    assert 100 < (train == 0).sum() < 300


def test_dropout_on_tensors_follows_module_training():
    """Called on tensors (TrainStep, the engine), Dropout follows
    Module.training, as before the Gluon surface."""
    drop = tmx.gluon.nn.Dropout(0.5)
    x = torch.ones(400)
    assert (drop(x) == 0).any()
    drop.eval()
    assert torch.equal(drop(x), x)


def _grads(net, ids, labels):
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with tmx.autograd.record():
        loss = loss_fn(net(ids), labels)
    loss.backward()
    return loss.asnumpy(), {k: p.grad().asnumpy().copy()
                            for k, p in net.collect_params().items()}


def test_remat_gradients_equal_the_plain_ones():
    net = tgpt2.GPT2Model(device="cpu", seed=2, **GPT2)
    rs = np.random.RandomState(1)
    ids = tmx.nd.array(rs.randint(0, 97, (2, 12)), ctx=tmx.cpu())
    labels = tmx.nd.array(rs.randint(0, 97, (2, 12)), ctx=tmx.cpu())
    loss0, g0 = _grads(net, ids, labels)
    net.hybridize(remat=True)
    assert all(b._remat for b in net.blocks)
    calls = []
    orig = torch.utils.checkpoint.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    torch.utils.checkpoint.checkpoint = counted
    try:
        loss1, g1 = _grads(net, ids, labels)
    finally:
        torch.utils.checkpoint.checkpoint = orig
    assert len(calls) == GPT2["num_layers"]
    np.testing.assert_allclose(loss1, loss0, **F32)
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], err_msg=k, **F32)
    with pytest.raises(ValueError, match="remat"):
        net.hybridize(remat="dots_saveable")


def test_parameter_semantics():
    """grad_req, lr_mult and cast act on the torch variable that the block
    registers; a Parameter without a context allocates on the current
    one."""
    with tmx.cpu():
        d = tmx.gluon.nn.Dense(3, in_units=2, prefix="d_")
        d.initialize()
    w = d.collect_params()["d_weight"]
    assert w.tensor() is d.weight and w.data()._data is d.weight
    w.grad_req = "null"
    assert not d.weight.requires_grad
    w.grad_req = "add"
    assert d.weight.requires_grad and w.grad_req == "add"
    w.lr_mult = 0.5
    assert d.weight.lr_mult == 0.5
    d.cast("bfloat16")
    assert d.weight.dtype == torch.bfloat16 and w.tensor() is d.weight
    assert w.dtype == "bfloat16"


def test_trainstep_takes_ndarray_batches_and_refuses_deferred_blocks():
    """TrainStep trains a Gluon block from NDArrays as from tensors, and
    refuses a block whose deferred shapes no forward has resolved."""
    x, y = _x((4, 6), 5), _x((4, 3), 6)
    losses = []
    for as_nd in (False, True):
        with tmx.cpu():
            net = _mlp(tmx, prefix=f"ts{int(as_nd)}_", in_units=6)
            net.initialize(init=tmx.init.Xavier())
        for p, q in zip(net.parameters(), _mlp_weights()):
            with torch.no_grad():
                p.copy_(q)
        ts = tmx.TrainStep(net, tmx.gluon.loss.L2Loss(),
                           tmx.optimizer.Adam(learning_rate=0.01),
                           amp=None)
        batch = (tmx.nd.array(x, ctx=tmx.cpu()),
                 tmx.nd.array(y, ctx=tmx.cpu())) if as_nd else \
            (torch.from_numpy(x), torch.from_numpy(y))
        losses.append([float(ts(*batch)) for _ in range(3)])
    assert losses[0] == losses[1]
    with tmx.cpu():
        deferred = _mlp(tmx, prefix="dfr_")
        deferred.initialize()
    with pytest.raises(tmx.MXNetError, match="deferred"):
        tmx.TrainStep(deferred, tmx.gluon.loss.L2Loss(),
                      tmx.optimizer.Adam())


def _mlp_weights():
    rs = np.random.RandomState(7)
    return [torch.from_numpy(rs.randn(*s).astype(np.float32) * 0.3)
            for s in ((8, 6), (8,), (3, 8), (3,))]
