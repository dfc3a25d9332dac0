"""Model configuration and family presets.

A copy of ``hadoop_tpu/models/config.py`` for the PyTorch port: the same
fields and the same ``PRESETS`` table, with ``torch_dtype`` in place of
``jax_dtype``. The port keeps its own copy because it never imports the
JAX package.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static hyperparameters of a decoder-only LM.

    ``family`` picks the architectural switches; everything else is sized
    explicitly so tiny test configs and real configs share one code path.
    """
    family: str = "llama"            # gpt2 | llama | mixtral
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8              # == n_heads for MHA (gpt2)
    d_ff: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    # architecture switches (derived from family by get_config)
    use_rope: bool = True            # else learned positional embedding
    use_rmsnorm: bool = True         # else LayerNorm with bias
    use_swiglu: bool = True          # else GeLU MLP
    tie_embeddings: bool = False
    # mixture of experts (0 experts = dense)
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    dtype: str = "bfloat16"          # activations/params compute dtype

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


def _gpt2(**kw) -> ModelConfig:
    base = dict(family="gpt2", use_rope=False, use_rmsnorm=False,
                use_swiglu=False, tie_embeddings=True, norm_eps=1e-5)
    base.update(kw)
    return ModelConfig(**base)


PRESETS = {
    "gpt2-125m": _gpt2(vocab_size=50257, d_model=768, n_layers=12,
                       n_heads=12, n_kv_heads=12, d_ff=3072, max_seq=1024),
    "llama3-8b": ModelConfig(family="llama", vocab_size=128256, d_model=4096,
                             n_layers=32, n_heads=32, n_kv_heads=8,
                             d_ff=14336, max_seq=8192),
    "llama3-70b": ModelConfig(family="llama", vocab_size=128256, d_model=8192,
                              n_layers=80, n_heads=64, n_kv_heads=8,
                              d_ff=28672, max_seq=8192),
    "gpt3-13b": _gpt2(vocab_size=50257, d_model=5120, n_layers=40,
                      n_heads=40, n_kv_heads=40, d_ff=20480, max_seq=2048),
    "mixtral-8x7b": ModelConfig(family="mixtral", vocab_size=32000,
                                d_model=4096, n_layers=32, n_heads=32,
                                n_kv_heads=8, d_ff=14336, max_seq=8192,
                                n_experts=8, top_k=2, rope_theta=1e6),
    "flagship-420m": ModelConfig(family="llama", vocab_size=32768,
                                 d_model=1024, n_layers=24, n_heads=16,
                                 n_kv_heads=8, d_ff=2816, max_seq=2048,
                                 rope_theta=500000.0),
    # the port's first served model: llama-style ~1B, 18 layers,
    # 16 query / 8 KV heads of width 128
    "flagship-1b": ModelConfig(family="llama", vocab_size=32768,
                               d_model=2048, n_layers=18, n_heads=16,
                               n_kv_heads=8, d_ff=5632, max_seq=2048,
                               rope_theta=500000.0),
    # tiny configs for tests
    "tiny": ModelConfig(family="llama", vocab_size=256, d_model=64,
                        n_layers=4, n_heads=4, n_kv_heads=2, d_ff=128,
                        max_seq=128, dtype="float32", rope_theta=10000.0),
    "tiny-moe": ModelConfig(family="mixtral", vocab_size=256, d_model=64,
                            n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
                            max_seq=128, n_experts=4, top_k=2,
                            dtype="float32", rope_theta=10000.0),
    "tiny-gpt2": _gpt2(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                       n_kv_heads=4, d_ff=256, max_seq=128, dtype="float32"),
}


def get_config(name: str, **overrides) -> ModelConfig:
    cfg = PRESETS[name]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
