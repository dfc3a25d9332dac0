"""Model families of the PyTorch port (llama, gpt2 and mixtral MoE,
single device)."""

from hadoop_tpu_torch.models.config import PRESETS, ModelConfig, get_config
from hadoop_tpu_torch.models.convert import params_from_numpy
from hadoop_tpu_torch.models.decoder import forward, init_params

__all__ = ["ModelConfig", "PRESETS", "get_config", "init_params", "forward",
           "params_from_numpy"]
