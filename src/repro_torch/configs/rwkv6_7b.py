"""rwkv6-7b (Finch) — attention-free RNN with data-dependent decay, 32L,
d_model 4096, d_ff 14336, vocab 65536. [arXiv:2404.05892; hf]"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchConfig

CONFIG = register(ArchConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, d_ff=14336,
    vocab=65536, head_dim=64, attention_free=True, sub_quadratic=True,
    norm="layernorm", mlp="rwkv",
    source="arXiv:2404.05892; hf",
))
