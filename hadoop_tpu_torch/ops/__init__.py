"""Device ops of the PyTorch port: plain PyTorch functions, and the
hand-written CUDA kernels where the JAX package had a Pallas kernel."""

from hadoop_tpu_torch.ops.activations import gelu, swiglu
from hadoop_tpu_torch.ops.attention import causal_attention
from hadoop_tpu_torch.ops.norms import layer_norm, rms_norm
from hadoop_tpu_torch.ops.rope import apply_rope, rope_frequencies

__all__ = ["gelu", "swiglu", "causal_attention", "layer_norm", "rms_norm",
           "apply_rope", "rope_frequencies"]
