"""granite-34b — dense llama-arch (code), 88L, d_model 6144, 48H MQA(kv=1),
d_ff 24576, vocab 49152. [arXiv:2405.04324; hf]"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchConfig

CONFIG = register(ArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab=49152, head_dim=128, tie_embeddings=True, mlp="gelu",
    source="arXiv:2405.04324; hf",
))
