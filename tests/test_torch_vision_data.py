"""The port's image data path against the JAX package: the synthetic
vision datasets byte for byte, each of the 15 transform blocks (exact, or
for ``Resize`` within 1 of 255 on uint8 and 1e-4 on float: the two
bilinear filters sum in other orders), the ``image`` augmenters,
``recordio`` files that either package writes read by the other byte for
byte, ``imdecode`` of PIL-written JPEGs pixel for pixel through the shared
C++ decoder, ``ImageRecordIter`` batches, and three steps of the port's
MNIST example against the JAX loop (losses 1e-5 relative, weights 1e-4,
tests/test_torch_vision_train.py's LeNet tolerances)."""
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import image as jimage
from mxnet_tpu.gluon.data.vision import datasets as jds
from mxnet_tpu.gluon.data.vision import transforms as jtr
from mxnet_tpu.io import image_iter as jii
from mxnet_tpu.io import recordio as jrec
from mxnet_tpu_torch import image as timage
from mxnet_tpu_torch.gluon.data.vision import datasets as tds
from mxnet_tpu_torch.gluon.data.vision import transforms as ttr
from mxnet_tpu_torch.io import image_iter as tii
from mxnet_tpu_torch.io import recordio as trec

from test_torch_vision_layers import name_counters  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))


@pytest.mark.parametrize("name,train", [
    ("MNIST", True), ("MNIST", False), ("FashionMNIST", True),
    ("CIFAR10", True), ("CIFAR10", False), ("CIFAR100", True)])
def test_synthetic_datasets_equal_jax(tmp_path, name, train):
    """No files under root: both packages make the seeded synthetic set,
    and the port's samples are host uint8 NDArrays with int32 labels."""
    root = str(tmp_path / "none")
    j = getattr(jds, name)(root=root, train=train)
    t = getattr(tds, name)(root=root, train=train)
    assert t._data.dtype == j._data.dtype and t._label.dtype == \
        j._label.dtype
    assert t._data.tobytes() == j._data.tobytes()
    assert t._label.tobytes() == j._label.tobytes()
    assert len(t) == len(j)
    x, y = t[5]
    jx, jy = j[5]
    assert x.context == tmx.cpu() and x.dtype == np.uint8
    np.testing.assert_array_equal(x.asnumpy(), jx.asnumpy())
    assert y == jy


def test_mnist_reads_idx_files(tmp_path):
    import gzip

    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (5, 28, 28), dtype=np.uint8)
    labels = rs.randint(0, 10, 5).astype(np.uint8)
    with gzip.open(tmp_path / "t10k-images-idx3-ubyte.gz", "wb") as f:
        f.write(np.array([2051, 5, 28, 28], ">u4").tobytes() + imgs.tobytes())
    with gzip.open(tmp_path / "t10k-labels-idx1-ubyte.gz", "wb") as f:
        f.write(np.array([2049, 5], ">u4").tobytes() + labels.tobytes())
    t = tds.MNIST(root=str(tmp_path), train=False)
    j = jds.MNIST(root=str(tmp_path), train=False)
    assert t._data.tobytes() == j._data.tobytes() == imgs.tobytes()
    np.testing.assert_array_equal(t._label, j._label)


def _img(shape=(12, 10, 3), seed=0, dtype=np.uint8):
    rs = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rs.randint(0, 256, shape).astype(np.uint8)
    return (rs.rand(*shape) * 255).astype(dtype)


# name -> (port transform, JAX transform) factories; each random one is
# drawn from RandomState(7) (port, explicit) and np.random.seed(7) (JAX)
TRANSFORMS = {
    "Cast": lambda m, r: m.Cast("float32"),
    "ToTensor": lambda m, r: m.ToTensor(),
    "Normalize": lambda m, r: m.Normalize((0.1, 0.2, 0.3), (0.5, 0.6, 0.7)),
    "CenterCrop": lambda m, r: m.CenterCrop((6, 4)),
    "Resize_down": lambda m, r: m.Resize((7, 5)),
    "Resize_up": lambda m, r: m.Resize(17),
    "Compose": lambda m, r: m.Compose([m.CenterCrop(8), m.ToTensor(),
                                       m.Normalize(0.5, 0.25)]),
    "RandomResizedCrop": lambda m, r: m.RandomResizedCrop(8, **r),
    "RandomFlipLeftRight": lambda m, r: m.RandomFlipLeftRight(**r),
    "RandomFlipTopBottom": lambda m, r: m.RandomFlipTopBottom(**r),
    "RandomBrightness": lambda m, r: m.RandomBrightness(0.4, **r),
    "RandomContrast": lambda m, r: m.RandomContrast(0.4, **r),
    "RandomSaturation": lambda m, r: m.RandomSaturation(0.4, **r),
    "RandomHue": lambda m, r: m.RandomHue(0.3, **r),
    "RandomColorJitter": lambda m, r: m.RandomColorJitter(0.3, 0.3, 0.3, 0.2,
                                                          **r),
    "RandomLighting": lambda m, r: m.RandomLighting(0.5, **r),
}


def _run_transform(name, x):
    if name == "Normalize":  # a CHW float image (ToTensor's output)
        x = np.ascontiguousarray(x.transpose(2, 0, 1)).astype(np.float32)
    np.random.seed(7)
    jt = TRANSFORMS[name](jtr, {})
    want = [jt(jmx.nd.array(x, dtype=x.dtype)).asnumpy() for _ in range(4)]
    rng = np.random.RandomState(7)
    tt = TRANSFORMS[name](ttr, {"rng": rng} if name.startswith("Random")
                          else {})
    got = [tt(tmx.nd.array(x, ctx=tmx.cpu(), dtype=x.dtype)).asnumpy()
           for _ in range(4)]
    return got, want


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name, dtype):
    """Four calls of one block on a 12x10 RGB image; the random blocks
    draw the same values from the same seed."""
    got, want = _run_transform(name, _img(dtype=dtype))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name.startswith("Resize") or name == "RandomResizedCrop":
            tol = 1 if dtype == np.uint8 else 1e-4 * 255
            assert np.abs(g.astype(np.float64) - w).max() <= tol, name
        elif dtype == np.float32 or g.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-4,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_the_fifteen_transform_blocks_are_ported():
    blocks = {n for n in jtr.__all__}
    assert blocks == set(ttr.__all__) and len(blocks) == 15


AUGS = {
    "resize_short": (lambda m, x, r: m.resize_short(x, 7)),
    "center_crop": (lambda m, x, r: m.center_crop(x, (6, 5))[0]),
    "random_crop": (lambda m, x, r: m.random_crop(x, (6, 5), **r)[0]),
    "CreateAugmenter": None,
}


@pytest.mark.parametrize("name", sorted(AUGS))
def test_image_augmenters_match_jax(name):
    """The image module on a host uint8 image (the native resize on both
    sides): a CreateAugmenter list with every random augmenter, four
    calls, against the JAX list from the same seed."""
    x = _img((14, 11, 3), seed=2)
    if AUGS[name] is not None:
        np.random.seed(3)
        want = AUGS[name](jimage, x, {})
        got = AUGS[name](timage, x, {"rng": np.random.RandomState(3)})
        np.testing.assert_array_equal(np.asarray(got.asnumpy() if hasattr(
            got, "asnumpy") else got), np.asarray(want.asnumpy() if hasattr(
                want, "asnumpy") else want))
        return
    kw = dict(resize=12, rand_crop=True, rand_mirror=True, brightness=0.3,
              contrast=0.3, saturation=0.3, hue=0.2, pca_noise=0.1,
              mean=np.array([120.0, 110.0, 100.0], np.float32),
              std=np.array([50.0, 60.0, 70.0], np.float32))
    np.random.seed(5)
    jaugs = jimage.CreateAugmenter((3, 8, 8), **kw)
    taugs = timage.CreateAugmenter((3, 8, 8), rng=np.random.RandomState(5),
                                   **kw)
    assert [type(a).__name__ for a in jaugs] == \
        [type(a).__name__ for a in taugs]
    for _ in range(3):
        j, t = x, x
        for a in jaugs:
            j = a(j)
        for a in taugs:
            t = a(t)
        np.testing.assert_allclose(t.asnumpy(), np.asarray(j.asnumpy()),
                                   rtol=1e-5, atol=1e-4)


def test_imresize_of_a_tensor_matches_jax():
    """Off the native path (a float NDArray): F.interpolate against
    jax.image.resize(antialias=False), up and down."""
    x = _img((9, 13, 3), seed=4, dtype=np.float32)
    for w, h in ((20, 15), (6, 4)):
        want = jimage.imresize(jmx.nd.array(x), w, h).asnumpy()
        got = timage.imresize(tmx.nd.array(x, ctx=tmx.cpu()), w, h).asnumpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def _jpeg(seed, shape=(20, 28, 3), quality=90):
    import PIL.Image

    rs = np.random.RandomState(seed)
    base = np.linspace(0, 255, shape[0] * shape[1] * 3).reshape(shape)
    img = np.clip(base + rs.randint(-40, 40, shape), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    PIL.Image.fromarray(img).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


@pytest.mark.parametrize("flag,to_rgb", [(1, 1), (1, 0), (0, 1)])
def test_imdecode_of_pil_jpegs_equals_jax(flag, to_rgb):
    for seed in range(3):
        buf = _jpeg(seed)
        want = jimage.imdecode(buf, to_rgb=to_rgb, flag=flag).asnumpy()
        got = timage.imdecode(buf, to_rgb=to_rgb, flag=flag)
        assert got.context == tmx.cpu() and got.dtype == np.uint8
        np.testing.assert_array_equal(got.asnumpy(), want)
    # npy payloads load directly, 2-D ones as three equal channels
    npy = io.BytesIO()
    np.save(npy, _img((5, 4), seed=1))
    np.testing.assert_array_equal(
        timage.imdecode(npy.getvalue()).asnumpy(),
        jimage.imdecode(npy.getvalue()).asnumpy())


def _write_rec(mod, path, n=6, fmt=".jpg"):
    idx = path[:-4] + ".idx"
    rec = mod.IndexedRecordIO(idx, path, "w")
    for i in range(n):
        img = _img((16 + i, 20, 3), seed=10 + i)
        label = float(i % 3) if i % 2 else [float(i), 2.0 * i]
        rec.write_idx(i, mod.pack_img(mod.IRHeader(0, label, i, 0), img,
                                      quality=90, img_fmt=fmt))
    rec.close()
    return idx


@pytest.mark.parametrize("fmt", [".jpg", ".npy"])
def test_recordio_files_cross_the_packages(tmp_path, fmt):
    """Each package writes the same images: the files are byte-equal, and
    each reads the other's records to the same headers and pixels."""
    jpath, tpath = str(tmp_path / "j.rec"), str(tmp_path / "t.rec")
    jidx, tidx = _write_rec(jrec, jpath, fmt=fmt), _write_rec(trec, tpath,
                                                              fmt=fmt)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    assert open(jidx).read() == open(tidx).read()
    for reader, wmod, path, idx in ((trec, jrec, jpath, jidx),
                                    (jrec, trec, tpath, tidx)):
        r = reader.IndexedRecordIO(idx, path, "r")
        for k in r.keys:
            h, img = reader.unpack_img(r.read_idx(k))
            h2, img2 = wmod.unpack_img(r.read_idx(k))
            assert (h.flag, h.id, h.id2) == (h2.flag, h2.id, h2.id2)
            np.testing.assert_array_equal(np.asarray(h.label),
                                          np.asarray(h2.label))
            np.testing.assert_array_equal(img, img2)
        r.close()
    # plain MXRecordIO and pack/unpack of raw bytes
    p = str(tmp_path / "raw.rec")
    w = trec.MXRecordIO(p, "w")
    for s in (b"", b"abc", b"x" * 13):
        w.write(trec.pack(trec.IRHeader(0, 1.5, 7, 0), s))
    w.close()
    r = jrec.MXRecordIO(p, "r")
    assert [jrec.unpack(r.read())[1] for _ in range(3)] == \
        [b"", b"abc", b"x" * 13]
    assert r.read() is None


def test_image_record_dataset_matches_jax(tmp_path):
    path = str(tmp_path / "d.rec")
    _write_rec(jrec, path)
    j = jds.ImageRecordDataset(path)
    t = tds.ImageRecordDataset(path)
    assert len(t) == len(j) == 6
    for i in range(len(t)):
        (x, y), (jx, jy) = t[i], j[i]
        np.testing.assert_array_equal(x.asnumpy(), jx.asnumpy())
        np.testing.assert_array_equal(np.asarray(y), np.asarray(jy))
    # RecordFileDataset reads <file>.idx
    (tmp_path / "d.rec.idx").write_text((tmp_path / "d.idx").read_text())
    raw = tmx.gluon.data.RecordFileDataset(path)
    assert raw[2] == jmx.gluon.data.RecordFileDataset(path)[2]


def test_image_folder_dataset_matches_jax(tmp_path):
    for cls, seeds in (("cat", (0, 1)), ("dog", (2,))):
        (tmp_path / cls).mkdir()
        for s in seeds:
            (tmp_path / cls / f"{s}.jpg").write_bytes(_jpeg(s))
    np.save(tmp_path / "dog" / "3.npy", _img((8, 6, 3), seed=3))
    j = jds.ImageFolderDataset(str(tmp_path))
    t = tds.ImageFolderDataset(str(tmp_path))
    assert t.synsets == j.synsets == ["cat", "dog"] and len(t) == 4
    for i in range(len(t)):
        np.testing.assert_array_equal(t[i][0].asnumpy(), j[i][0].asnumpy())
        assert t[i][1] == j[i][1]


@pytest.mark.parametrize("opts", [
    dict(),
    dict(shuffle=True, rand_crop=True, rand_mirror=True, resize=14,
         mean_r=120.0, mean_g=110.0, mean_b=100.0, std_r=50.0, std_g=60.0,
         std_b=70.0),
    dict(label_width=2, round_batch=True, num_parts=2, part_index=1)],
    ids=["center", "random", "parts"])
def test_image_record_iter_matches_jax(tmp_path, opts):
    path = str(tmp_path / "it.rec")
    _write_rec(jrec, path, n=7)
    kw = dict(data_shape=(3, 12, 12), batch_size=3, seed=4,
              preprocess_threads=2, **opts)
    j = jii.ImageRecordIter(path, **kw)
    t = tii.ImageRecordIter(path, **kw)
    n = 0
    for _ in range(2):  # two epochs: the shuffled order and draws carry on
        for jb, tb in zip(j, t):
            assert tb.data[0].context == tmx.cpu()
            assert tb.data[0].shape == (3, 3, 12, 12)
            np.testing.assert_array_equal(tb.data[0].asnumpy(),
                                          jb.data[0].asnumpy())
            np.testing.assert_array_equal(tb.label[0].asnumpy(),
                                          jb.label[0].asnumpy())
            assert tb.pad == jb.pad
            n += 1
        j.reset()
        t.reset()
    assert n >= 2
    j.close()
    t.close()


def test_image_record_iter_feeds_the_device_prefetcher(tmp_path):
    """The iterator plugs into DevicePrefetcher as NDArrayIter does."""
    path = str(tmp_path / "p.rec")
    _write_rec(jrec, path, n=6)
    it = tii.ImageRecordIter(path, data_shape=(3, 8, 8), batch_size=2)
    want = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in it]
    it.reset()
    pf = tmx.io.DevicePrefetcher(it, window=3, device="cpu")
    kind, batch, k = pf.next_group()
    assert (kind, k) == ("window", 3) and batch[0].shape == (3, 2, 3, 8, 8)
    assert pf.next_group()[0] is None
    for i, (x, y) in enumerate(want):
        np.testing.assert_array_equal(batch[0][i].numpy(), x)
        np.testing.assert_array_equal(batch[1][i].numpy(), y)
    it.close()


def test_native_loader_builds_into_the_port(tmp_path):
    """The loader's library lives under mxnet_tpu_torch/_build, and the
    data modules and an MNIST pass through them import no JAX."""
    from mxnet_tpu_torch import native

    assert native.build().parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "_build" and \
        native.BUILD_DIR.parent.name == "mxnet_tpu_torch"
    code = ("import sys, numpy as np, mxnet_tpu_torch as mx; "
            "import mxnet_tpu_torch.gluon.data.vision as v; "
            "import mxnet_tpu_torch.io.image_iter, mxnet_tpu_torch.image; "
            "ds = v.MNIST(train=False); x, y = ds[0]; "
            "import mxnet_tpu_torch.native; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'mxnet_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout


def test_pack_img_without_an_encoder_raises(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_codecs(name, *a, **k):
        if name.split(".")[0] in ("cv2", "PIL"):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_codecs)
    with pytest.raises(tmx.MXNetError, match="cv2 or PIL"):
        trec.pack_img(trec.IRHeader(0, 0.0, 0, 0), _img())
    # npy stays available
    assert trec.pack_img(trec.IRHeader(0, 0.0, 0, 0), _img(),
                         img_fmt=".npy")[24:30] == b"\x93NUMPY"


def _jax_mnist_steps(weights, batches):
    with jmx.cpu():
        net = jmx.gluon.model_zoo.get_model("lenet")
        net.initialize(jmx.init.Xavier())
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(weights[k])
    net.hybridize()
    trainer = jmx.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 2e-3})
    loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for data, label in batches:
        x = data.transpose((0, 3, 1, 2))
        with jmx.autograd.record():
            loss = loss_fn(net(x), label)
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.mean().asnumpy()))
    return net, losses


def test_three_mnist_example_steps_match_jax():
    """The port example's loaders and step on the synthetic MNIST, from
    the same LeNet weights, against the JAX example's loop on the JAX
    package's loader (unshuffled, so both see the same batches)."""
    import torch_train_mnist as tex

    rs = np.random.RandomState(11)
    shapes = {"features.0.weight": (6, 1, 5, 5), "features.0.bias": (6,),
              "features.2.weight": (16, 6, 5, 5), "features.2.bias": (16,),
              "features.5.weight": (120, 400), "features.5.bias": (120,),
              "features.6.weight": (84, 120), "features.6.bias": (84,),
              "output.weight": (10, 84), "output.bias": (10,)}
    weights = {k: (rs.randn(*s) * 0.1).astype(np.float32)
               for k, s in shapes.items()}
    jload = jmx.gluon.data.DataLoader(
        jds.MNIST(train=True).transform_first(
            lambda d: d.astype("float32") / 255.0), batch_size=32)
    jbatches = []
    for i, b in enumerate(jload):
        if i == 3:
            break
        jbatches.append(b)
    jnet, jlosses = _jax_mnist_steps(weights, jbatches)

    train_data, _ = tex.data_loaders(32, shuffle=False)
    with tmx.cpu():
        net = tmx.gluon.model_zoo.get_model("lenet")
        net.initialize(tmx.init.Xavier())
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(weights[k])
        net.hybridize()
        trainer = tmx.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 2e-3})
        loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
        metric = tmx.metric.Accuracy()
        losses = []
        for i, (data, label) in enumerate(train_data):
            if i == 3:
                break
            np.testing.assert_array_equal(data.asnumpy(),
                                          jbatches[i][0].asnumpy())
            loss = tex.step(net, trainer, loss_fn, data, label, metric)
            losses.append(float(loss.mean().asnumpy()))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-6)
    want = {k: p.data().asnumpy()
            for k, p in jnet._collect_params_with_prefix().items()}
    for k, p in net._collect_params_with_prefix().items():
        np.testing.assert_allclose(p.data().asnumpy(), want[k], err_msg=k,
                                   rtol=1e-4, atol=1e-5)
    assert metric.get()[0] == "accuracy" and metric.num_inst == 96
