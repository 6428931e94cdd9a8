"""PyTorch/CUDA port of ``mxnet_tpu`` for one NVIDIA H100.

The MXNet surface: ``mx.nd`` (NDArray over ``torch.Tensor``), ``autograd``,
``random``, ``init``, Gluon ``Parameter``/``Block``/``HybridBlock``, layers,
losses and ``Trainer``, and ``Context`` (``mx.gpu()`` is the card, and the
default). Under it: GPT-2 and BERT (``models``), the generation engine and
continuous batcher (``inference``), the single-device ``TrainStep``
(``parallel``) with its optimizers (``optimizer``), and the hand-written
CUDA kernels on those paths (``ops``, sources in ``csrc/``): paged
attention, LayerNorm, flash attention (forward, dK/dV, dQ), multi-tensor
Adam and softmax cross-entropy. The training loop: ``TrainStep.run`` and
``gluon.Trainer.run`` (one CUDA graph a window of steps), fed by
``io.DevicePrefetcher`` from ``io`` iterators or ``gluon.data.DataLoader``,
with crash-safe ``checkpoint``s, preemption (``resilience``) and
``mon.Monitor``. The image data path: ``image``, ``io.recordio``,
``io.ImageRecordIter`` and ``gluon.data.vision``, over the shared C++
decoder (``native``). Detection: the contrib ops (``ops.contrib_vision``)
and the SSD (``models.ssd``). The training utilities: ``callback``, the
Gluon ``Estimator`` (``gluon.contrib.estimator``), ``test_utils``,
``runtime.Features`` and ``AttrScope``. The symbolic API: ``sym``
(``symbol``: the Symbol graph, its JSON and ``Executor``),
``HybridBlock.export`` and ``gluon.SymbolBlock``, ``mod`` (``module``:
``Module``, ``BucketingModule``), ``model``, ``rnn`` (the symbolic cells,
``BucketSentenceIter``), ``viz`` and ``operator`` (CustomOp, ``nd.Custom``,
``sym.Custom``). Row-sparse and CSR storage: ``nd.sparse``, lazy optimizer
updates, ``Embedding(sparse_grad=True)``. The numpy namespace: ``np`` and
``npx`` (``numpy_api``). INT8 post-training quantization on a
hand-written s8 tensor-core kernel (``contrib.quantization``) and ONNX
export and import (``contrib.onnx``). Imports torch, numpy and the standard
library only. Entry points run on the card unless the caller names the
CPU (``device="cpu"``, ``ctx=mx.cpu()``), which runs the kernels' plain
PyTorch versions.
"""
from . import base, config
from .base import MXNetError
from .context import Context, cpu, current_context, gpu, num_gpus
from . import ndarray
from . import ndarray as nd
from .ndarray import NDArray
from . import autograd, random
from . import initializer
from . import initializer as init
from . import (gluon, inference, lr_scheduler, models, ops, optimizer,
               parallel, serialization)
from . import checkpoint, image, io, metric, monitor
from . import monitor as mon
from .monitor import Monitor
from . import observability
from . import observability as obs
from . import resilience
from . import callback, runtime, test_utils
from . import symbol
from . import symbol as sym
from . import operator, rnn, model, module
from . import module as mod
from . import visualization
from . import visualization as viz
from .numpy_api import np, npx
from .attribute import AttrScope
from .util import is_np_array
from .inference import ContinuousBatcher, GenerationEngine, SamplingConfig
from .models import get_gpt2
from .parallel import TrainStep

__all__ = ["base", "config", "MXNetError", "Context", "cpu", "gpu",
           "current_context", "num_gpus", "ndarray", "nd", "NDArray",
           "autograd", "random", "initializer", "init", "gluon", "inference",
           "lr_scheduler", "models", "ops", "optimizer", "parallel",
           "serialization", "checkpoint", "image", "io", "metric", "monitor", "mon",
           "Monitor", "observability", "obs", "resilience", "callback",
           "runtime", "test_utils", "AttrScope", "is_np_array", "symbol",
           "sym", "operator", "rnn", "model", "module", "mod",
           "visualization", "viz", "np", "npx",
           "ContinuousBatcher", "GenerationEngine",
           "SamplingConfig", "TrainStep", "get_gpt2"]
