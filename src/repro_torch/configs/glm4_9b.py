"""glm4-9b — dense, 40L, d_model 4096, 32H GQA(kv=2), d_ff 13696,
vocab 151552, RoPE. [hf:THUDM/glm-4-9b; hf]"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchConfig

CONFIG = register(ArchConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab=151552, head_dim=128,
    source="hf:THUDM/glm-4-9b; hf",
))
