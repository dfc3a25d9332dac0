"""hadoop_tpu_torch — the device layer of ``hadoop_tpu`` in PyTorch, for
one NVIDIA H100.

Module paths mirror the JAX package (``models/``, ``ops/``,
``parallel/``, ``serving/``), so each module's counterpart is found under the same name
there; ``hadoop_tpu`` stays the reference each module is tested against.
The port imports ``torch`` and numpy and never JAX or ``hadoop_tpu``.
Every TPU kernel on a ported path is a hand-written Hopper kernel
(``ops/csrc/``), built on first use.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
without a CUDA device and without that request they raise.
"""

from hadoop_tpu_torch.models.config import get_config
from hadoop_tpu_torch.models.decoder import forward, init_params
from hadoop_tpu_torch.parallel.train import init_train_state, make_train_step
from hadoop_tpu_torch.serving.engine import DecodeEngine, SamplingParams

__all__ = ["get_config", "forward", "init_params", "init_train_state",
           "make_train_step", "DecodeEngine", "SamplingParams"]
