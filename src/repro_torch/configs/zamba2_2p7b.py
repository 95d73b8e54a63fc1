"""zamba2-2.7b — hybrid: Mamba2 backbone + shared attention block, 54L,
d_model 2560, 32H GQA(kv=32), d_ff 10240, ssm_state 64, vocab 32000.
[arXiv:2411.15242; hf]"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = register(ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, head_dim=80, sub_quadratic=True,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, attn_every=6),
    source="arXiv:2411.15242; hf",
))
