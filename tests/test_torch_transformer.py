"""The WMT Transformer in the port (mxnet_tpu_torch.models.transformer)
against the JAX package with the same weights, at transformer_tiny's
widths (2 layers, units 64, 2 heads, so head dim 32) with vocab 211 and
dropout 0: the structural and Gluon names, the tied embedding (written
under both names, loaded tied, updated once a step), ``.params`` files
both ways, the forward logits with and without ragged ``src_valid``,
``label_smoothing_loss`` with ignored rows, one backward's gradients,
three ``gluon.Trainer("adam")`` steps and three ``TrainStep`` steps
(``shared_embed`` True and False), the greedy cached decode, the
attention routes (head dim 32 plain, 64 and 128 flash), and the port
example's corpus and buckets against the JAX example's.

Tolerances are tests/test_torch_bert.py's f32 ones: forward and decode
logits 1e-4 (rtol and atol), the loss 1e-5 relative, gradients 1e-4
relative with an atol of 1e-4 of the tensor's largest entry, and after
three Adam steps no weight beyond the sign-flip bound 2 * lr * steps with
99.9% of them within 1e-2 * lr (the key biases, whose gradient is zero
but for rounding, only to the first)."""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import nd as jnd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.models import transformer as jtf
from mxnet_tpu.parallel import TrainStep as JTrainStep
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.models import transformer as ttf
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import flash_attention as tfa
from mxnet_tpu_torch.parallel import TrainStep

from test_torch_vision_layers import name_counters  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

V = 211
TINY_UNITS = 64
CFG = dict(vocab_size=V)
B, TS, TT = 3, 10, 9
VALID = np.array([TS, 6, 3], np.int32)
LR, STEPS = 1e-3, 3
FWD = dict(rtol=1e-4, atol=1e-4)
ADAM = dict(learning_rate=LR, beta1=0.9, beta2=0.98, epsilon=1e-9)


def _batch(seed=0):
    """(src, tgt_in, tgt_out, src_valid): pad (0) past each row's length,
    tgt_out with pad rows for the loss to ignore."""
    rs = np.random.RandomState(seed)
    src = rs.randint(3, V, (B, TS)).astype(np.int32)
    for i, n in enumerate(VALID):
        src[i, n:] = 0
    tgt_in = rs.randint(3, V, (B, TT)).astype(np.int32)
    tgt_out = rs.randint(3, V, (B, TT)).astype(np.int32)
    tgt_out[1, 5:] = 0
    tgt_out[2, 2:] = 0
    return src, tgt_in, tgt_out, VALID.copy()


def _jax_net(shared=True, seed=0):
    jmx.random.seed(seed)
    net = jtf.get_transformer("transformer_tiny", dropout=0.0,
                              shared_embed=shared, **CFG)
    net.initialize(jmx.init.Xavier())
    src, tgt_in, _, valid = _batch()
    net(jnd.array(src, dtype="int32"), jnd.array(tgt_in, dtype="int32"),
        jnd.array(valid, dtype="int32"))
    return net


def _port_net(shared=True, seed=3):
    return ttf.get_transformer("transformer_tiny", dropout=0.0,
                               shared_embed=shared, device="cpu", seed=seed,
                               **CFG)


def _jax_params(jnet):
    return {k: np.asarray(p.data().asnumpy())
            for k, p in jnet._collect_params_with_prefix().items()}


def _port_params(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


@pytest.fixture(scope="module", params=[True, False],
                ids=["shared", "unshared"])
def pair(request, tmp_path_factory):
    """A JAX net and a port net that loaded the JAX net's .params file."""
    jnet = _jax_net(request.param)
    fname = str(tmp_path_factory.mktemp("tf") / "jax.params")
    jnet.save_parameters(fname)
    tnet = _port_net(request.param)
    tnet.load_parameters(fname)
    return request.param, jnet, tnet, fname


def _j(*arrays):
    return [None if a is None else jnd.array(a, dtype="int32")
            for a in arrays]


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def test_names_equal_the_jax_names(pair):
    shared, jnet, tnet, _ = pair
    assert list(tnet._collect_params_with_prefix()) == \
        list(jnet._collect_params_with_prefix())
    assert [k.split("_", 1)[1] for k in tnet.collect_params()] == \
        [k.split("_", 1)[1] for k in jnet.collect_params()]
    names = list(tnet.collect_params())
    assert names[0].endswith("_word_embed_weight")
    assert any(n.endswith("_dec1_cattn_key_weight") for n in names)
    assert any(n.endswith("_dec0_ln3_gamma") for n in names)
    assert names[-1].endswith("_outproj_bias")
    structural = list(tnet._collect_params_with_prefix())
    assert "dec_layers.0.cross_attn.kv_proj.weight" in structural
    assert "enc_layers.1.ffn.ffn2.bias" in structural
    # the tied table: two structural names, one parameter
    n_tensors = len(structural) - (1 if shared else 0)
    assert len(list(tnet.named_parameters())) == n_tensors
    assert len(tnet.collect_params()) == len(jnet.collect_params()) \
        == n_tensors
    assert (tnet.tgt_embed is tnet.src_embed) == shared


def test_jax_file_loads_into_the_port(pair):
    shared, jnet, tnet, _ = pair
    got, want = _port_params(tnet), _jax_params(jnet)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # load_parameters set the shared table twice and kept the tie
    assert (tnet.tgt_embed.weight is tnet.src_embed.weight) == shared


def test_port_file_loads_into_jax(pair, tmp_path):
    shared, jnet, tnet, _ = pair
    fname = str(tmp_path / "port.params")
    tnet.save_parameters(fname)
    written = tmx.serialization.load_ndarrays(fname)
    assert list(written) == list(jnet._collect_params_with_prefix())
    other = _jax_net(shared, seed=5)
    other.load_parameters(fname)
    src, tgt_in, _, valid = _batch(1)
    np.testing.assert_array_equal(
        other(*_j(src, tgt_in, valid)).asnumpy(),
        jnet(*_j(src, tgt_in, valid)).asnumpy())


@pytest.mark.parametrize("ragged", [True, False], ids=["src_valid", "full"])
def test_forward_matches_jax(pair, ragged):
    _, jnet, tnet, _ = pair
    src, tgt_in, _, valid = _batch()
    valid = valid if ragged else None
    want = jnet(*_j(src, tgt_in, valid)).asnumpy()
    with torch.no_grad():
        got = tnet(*_t(src, tgt_in, valid)).numpy()
    assert got.shape == (B, TT, V)
    np.testing.assert_allclose(got, want, **FWD)


def test_label_smoothing_loss_matches_jax():
    """Pad rows (label 0) are ignored, and an all-pad batch gives 0."""
    rs = np.random.RandomState(7)
    logits = (3 * rs.randn(B, TT, V)).astype(np.float32)
    _, _, labels, _ = _batch()
    for eps in (0.1, 0.0):
        want = float(jtf.label_smoothing_loss(
            jnd.array(logits), jnd.array(labels, dtype="int32"),
            epsilon=eps).asnumpy())
        got = ttf.label_smoothing_loss(torch.from_numpy(logits),
                                       torch.from_numpy(labels), epsilon=eps)
        assert got.dim() == 0 and got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-5 * abs(want)
    # NDArrays in, an NDArray out
    nd_loss = ttf.label_smoothing_loss(tmx.nd.array(logits, ctx=tmx.cpu()),
                                       tmx.nd.array(labels, ctx=tmx.cpu()))
    assert isinstance(nd_loss, tmx.NDArray)
    zero = ttf.label_smoothing_loss(torch.from_numpy(logits),
                                    torch.zeros((B, TT), dtype=torch.int32))
    assert float(zero) == 0.0


def test_one_backward_matches_jax(pair):
    shared, jnet, tnet, _ = pair
    src, tgt_in, tgt_out, valid = _batch()
    with jmx.autograd.record():
        jloss = jtf.label_smoothing_loss(jnet(*_j(src, tgt_in, valid)),
                                         *_j(tgt_out))
    jloss.backward()
    tnet.zero_grad()
    loss = ttf.label_smoothing_loss(tnet(*_t(src, tgt_in, valid)),
                                    *_t(tgt_out))
    loss.backward()
    assert abs(loss.item() - float(jloss.asnumpy())) <= \
        1e-5 * abs(loss.item())
    jgrads = {k: np.asarray(p.grad().asnumpy()) for k, p in
              jnet._collect_params_with_prefix().items()}
    for name, p in tnet.named_parameters():
        want = jgrads[name]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


def _key_bias(name, n):
    """The key entries of an attention bias: qkv.bias[u:2u] and
    kv_proj.bias[:u]. Their gradient is zero in exact arithmetic (adding
    a constant to a query's scores leaves its softmax unchanged), so Adam
    (epsilon 1e-9) turns either package's rounding noise into steps of
    +-lr. They are held to the sign-flip bound only."""
    keep = np.zeros(n, bool)
    u = TINY_UNITS
    if name.endswith("qkv.bias"):
        keep[u:2 * u] = True
    elif name.endswith("kv_proj.bias"):
        keep[:u] = True
    return keep


def _adam_close(final, want):
    err = np.concatenate([np.abs(final[k] - want[k]).ravel() for k in want])
    assert err.max() <= 2 * LR * STEPS
    err = np.concatenate([np.abs(final[k] - want[k]).ravel()[
        ~_key_bias(k, want[k].size)] for k in want])
    assert (err > 1e-2 * LR).mean() <= 1e-3


def _trainer_run(mx, tf, net, batch, ctx):
    trainer = mx.gluon.Trainer(net.collect_params(), "adam", dict(ADAM))
    losses = []
    with ctx:
        args = [mx.nd.array(a, dtype="int32") for a in batch]
        for _ in range(STEPS):
            with mx.autograd.record():
                loss = tf.label_smoothing_loss(net(args[0], args[1], args[3]),
                                               args[2])
            loss.backward()
            trainer.step(1)
            losses.append(float(loss.asnumpy()))
    return losses, trainer


def test_trainer_three_steps_match_jax(pair):
    """record / backward / Trainer("adam").step(1), as the example runs
    them; the tied table is one parameter of the Trainer and moves once a
    step."""
    shared, _, _, fname = pair
    jnet = _jax_net(shared)
    jnet.load_parameters(fname)
    tnet = _port_net(shared)
    tnet.load_parameters(fname)
    batch = _batch()
    jl, _ = _trainer_run(jmx, jtf, jnet, batch, jmx.cpu())
    tl, trainer = _trainer_run(tmx, ttf, tnet, batch, tmx.cpu())
    for got, want in zip(tl, jl):
        assert abs(got - want) <= 1e-5 * abs(want)
    final, want = _port_params(tnet), _jax_params(jnet)
    _adam_close(final, want)
    n_params = len(list(tnet.named_parameters()))
    assert len(trainer._params) == n_params
    assert trainer.optimizer.num_update == STEPS
    if shared:
        np.testing.assert_array_equal(final["src_embed.weight"],
                                      final["tgt_embed.weight"])


def _ts_loss(mod):
    def loss(out, labels):
        return mod.label_smoothing_loss(out.astype("float32") if
                                        not torch.is_tensor(out)
                                        else out.float(), labels)
    return loss


def test_trainstep_three_steps_match_jax(pair):
    shared, _, _, fname = pair
    jnet = _jax_net(shared)
    jnet.load_parameters(fname)
    src, tgt_in, tgt_out, valid = _batch()
    jts = JTrainStep(jnet, _ts_loss(jtf), jopt.Adam(**ADAM), mesh=None,
                     n_model_inputs=3)
    jbatch = _j(src, tgt_in, valid, tgt_out)
    jl = [float(np.asarray(jts(*jbatch))) for _ in range(STEPS)]
    jts.sync()
    tnet = _port_net(shared)
    tnet.load_parameters(fname)
    ts = TrainStep(tnet, _ts_loss(ttf), topt.Adam(**ADAM), n_model_inputs=3)
    tl = [float(ts(*_t(src, tgt_in, valid, tgt_out))) for _ in range(STEPS)]
    for got, want in zip(tl, jl):
        assert abs(got - want) <= 1e-5 * abs(want)
    final = _port_params(tnet)
    _adam_close(final, _jax_params(jnet))
    # the tied table has one optimizer state and one update a step
    assert len(ts.opt_state) == len(list(tnet.named_parameters()))
    assert (tnet.tgt_embed.weight is tnet.src_embed.weight) == shared
    assert ts.compiled_programs == 1


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "unshared"])
def test_amp_trainstep_leaves_the_f32_parameters_in_the_net(shared):
    """Under amp="bfloat16" the forward swaps the bf16 copies in and out
    of the net; afterwards every module holds its f32 parameter again, the
    one the step updates (the tied embedding, one submodule under two
    names, too), and the copy is its rounding."""
    net = _port_net(shared)
    before = dict(net.named_parameters())
    ts = TrainStep(net, _ts_loss(ttf), topt.Adam(**ADAM), n_model_inputs=3,
                   amp="bfloat16")
    src, tgt_in, tgt_out, valid = _batch()
    for _ in range(2):
        ts(*_t(src, tgt_in, valid, tgt_out))
    after = dict(net.named_parameters())
    assert after.keys() == before.keys()
    for name, p in after.items():
        assert p is before[name] and p.dtype == torch.float32, name
        assert torch.equal(ts._low[name], p.detach().to(torch.bfloat16)), name
    assert (net.tgt_embed.weight is net.src_embed.weight) == shared
    assert net.state_dict()["tgt_embed.weight"].dtype == torch.float32


def _greedy(net, mod, nd, src, valid, steps, wrap):
    mem, mem_mask = net.encode(nd, *wrap(src, valid))
    cache = net.init_decode_cache(B, 16)
    if mod is jtf:
        cache = [(jnd.NDArray(k), jnd.NDArray(v)) for k, v in cache]
    tok = np.full((B, 1), 1, np.int32)  # BOS
    toks, logits = [], []
    for t in range(steps):
        lg, cache = net.decode_step(
            *wrap(tok), mem, mem_mask, cache=cache,
            start_pos=wrap(np.full(B, t, np.int32))[0])
        lg = lg.asnumpy()[:, 0]
        tok = lg.argmax(-1).astype(np.int32)[:, None]
        toks.append(tok[:, 0])
        logits.append(lg)
    return np.stack(toks, 1), np.stack(logits, 1)


def test_greedy_decode_matches_jax(pair):
    """Eight greedy decode_step calls over init_decode_cache, tokens equal
    and logits at 1e-4; each step's logits also equal the port's full
    teacher-forced forward on the tokens so far."""
    _, jnet, tnet, _ = pair
    src, _, _, valid = _batch(2)
    jt, jlg = _greedy(jnet, jtf, jnd, src, valid, 8,
                      lambda *a: _j(*a))
    tt, tlg = _greedy(tnet, ttf, tmx.nd, src, valid, 8,
                      lambda *a: [tmx.nd.array(x, ctx=tmx.cpu(),
                                               dtype="int32") for x in a])
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tlg, jlg, **FWD)
    tgt = np.concatenate([np.ones((B, 1), np.int32), tt[:, :-1]], 1)
    with torch.no_grad():
        full = tnet(*_t(src, tgt, valid)).numpy()
    np.testing.assert_allclose(tlg, full, **FWD)


def test_decode_positions_past_the_table_are_clamped():
    """A row decoding at or past max_length reads the last position's
    embedding (the GPT-2 port's rule) where the JAX lookup gives NaN: its
    logits are finite and equal those at max_length - 1."""
    net = ttf.get_transformer("transformer_tiny", dropout=0.0, device="cpu",
                              seed=1, vocab_size=V, max_length=16)
    src, _, _, valid = _batch()
    with torch.no_grad():
        mem, mask = net.encode(None, *_t(src, valid))
        out = {}
        for pos in (15, 16, 40):
            cache = net.init_decode_cache(B, 16)
            lg, _ = net.decode_step(torch.ones((B, 1), dtype=torch.int32),
                                    mem, mask, cache=cache,
                                    start_pos=torch.full((B,), pos))
            out[pos] = lg
    assert torch.isfinite(out[40]).all()
    assert torch.equal(net._positions(1, torch.tensor([16, 40])),
                       torch.tensor([[15], [15]]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_attention_route_by_head_dim(dtype):
    """multi_head_attention("auto") sends head dim 32 to the plain path
    (the kernels are built for 64 and 128 only, as the JAX gate sends
    d % 64 != 0 to its einsum path) and 64 and 128 to flash; a mask or
    float16 also takes the plain path."""
    def qkv(d, dt=dtype):
        return [torch.zeros((2, 2, 8, d), dtype=dt) for _ in range(3)]

    assert tatt.attention_route(*qkv(32)) == "plain"
    assert tatt.attention_route(*qkv(64)) == "flash"
    assert tatt.attention_route(*qkv(128)) == "flash"
    assert tatt.attention_route(*qkv(96)) == "plain"
    mask = torch.ones((2, 1, 1, 8), dtype=torch.bool)
    assert tatt.attention_route(*qkv(64), mask=mask) == "plain"
    assert tatt.attention_route(*qkv(64, torch.float16)) == "plain"
    assert tatt.attention_route(*qkv(32), use_flash=True) == "flash"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_attention_route_ignores_launch_limits(dtype):
    """The "auto" route asks only the mask, the knob, q's dtype and its
    head dim: B·H past the kernels' grid limit of 65535, or k/v in another
    dtype than q, still route to flash, where a CUDA tensor then raises in
    the kernel's own check instead of quietly taking the plain path."""
    def qkv(b, h, dt=dtype):
        return [torch.zeros((1, 1, 4, 64), dtype=dt).expand(b, h, 4, 64)
                for _ in range(3)]

    assert tatt.attention_route(*qkv(256, 256)) == "flash"      # B·H 65536
    assert tatt.attention_route(*qkv(300, 300)) == "flash"
    assert not tfa.flash_supported(*qkv(300, 300))
    other = torch.float16 if dtype == torch.float32 else torch.float32
    q, k, v = qkv(2, 2)
    assert tatt.attention_route(q, k.to(other), v) == "flash"


@pytest.mark.parametrize("units,flash_calls", [(64, 0), (128, 2)],
                         ids=["d32", "d64"])
def test_only_the_decoder_self_attention_takes_flash(monkeypatch, units,
                                                     flash_calls):
    """At head dim 64 a forward sends the decoder's two causal
    self-attentions to flash and the masked encoder and cross-attentions
    to the plain path; at transformer_tiny's head dim 32 nothing reaches
    flash. Both forwards equal the knob-off forward at 1e-5."""
    calls = []
    real = tfa.flash_attention

    def counted(q, k, v, mask=None, causal=False):
        calls.append((tuple(q.shape), causal))
        return real(q, k, v, mask=mask, causal=causal)

    monkeypatch.setattr(tfa, "flash_attention", counted)
    net = ttf.get_transformer("transformer_tiny", dropout=0.0, device="cpu",
                              seed=2, vocab_size=V, units=units)
    src, tgt_in, _, valid = _batch()
    with torch.no_grad():
        got = net(*_t(src, tgt_in, valid))
        assert len(calls) == flash_calls
        assert all(causal and shape[2] == TT for shape, causal in calls)
        old = tmx.config.get("flash_attention")
        tmx.config.set("flash_attention", False)
        try:
            want = net(*_t(src, tgt_in, valid))
        finally:
            tmx.config.set("flash_attention", old)
    assert len(calls) == flash_calls
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_example_corpus_and_buckets_equal_the_jax_example():
    import torch_train_transformer_wmt as tex
    import train_transformer_wmt as jex

    for args in ((64, 50, 4, 20, 0), (200, 36500, 4, 28, 3)):
        js, jt = jex.synthetic_corpus(*args)
        ts, tt = tex.synthetic_corpus(*args)
        assert all(np.array_equal(a, b) for a, b in zip(js, ts))
        assert all(np.array_equal(a, b) for a, b in zip(jt, tt))
        for buckets in ([8, 16, 24], [8, 16, 24, 32]):
            jb = jex.bucket_batches(js, jt, buckets, 8, seed=args[-1])
            tb = tex.bucket_batches(ts, tt, buckets, 8, seed=args[-1])
            assert len(jb) == len(tb) > 0
            for a, b in zip(jb, tb):
                for x, y in zip(a, b):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
    jsched = jex.InvSqrtWarmup(512, 100, scale=0.5)
    tsched = tex.InvSqrtWarmup(512, 100, scale=0.5)
    assert [tsched(s) for s in (0, 1, 50, 100, 400)] == \
        [jsched(s) for s in (0, 1, 50, 100, 400)]


def test_example_loss_falls_on_the_cpu():
    """The port example's own loop at the JAX example's smoke flags."""
    import torch_train_transformer_wmt as tex

    args = tex.build_parser().parse_args([
        "--device", "cpu", "--n-sent", "256", "--vocab-size", "32",
        "--buckets", "8,12", "--max-len", "10", "--min-len", "4",
        "--batch-size", "16", "--epochs", "3", "--dropout", "0.0",
        "--num-layers", "1", "--units", "64", "--hidden-size", "128",
        "--num-heads", "2", "--warmup-steps", "60", "--lr-scale", "0.25",
        "--log-interval", "5"])
    history = tex.train(args)
    assert len(history) >= 6
    assert history[-1] < history[0] * 0.8, history
