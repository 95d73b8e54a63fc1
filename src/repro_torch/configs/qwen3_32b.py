"""qwen3-32b — dense, 64L, d_model 5120, 64H GQA(kv=8), d_ff 25600,
vocab 151936, qk_norm. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchConfig

CONFIG = register(ArchConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_ff=25600,
    vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B; hf",
))
