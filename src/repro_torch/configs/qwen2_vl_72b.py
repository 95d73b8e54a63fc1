"""qwen2-vl-72b — VLM transformer backbone with M-RoPE, 80L, d_model 8192,
64H GQA(kv=8), d_ff 29568, vocab 152064. The vision frontend is a STUB:
input_specs() supplies precomputed patch embeddings merged into the token
stream; M-RoPE carries (t, h, w) position streams. [arXiv:2409.12191; hf]"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchConfig

CONFIG = register(ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab=152064, head_dim=128, mrope_sections=(16, 24, 24), rope_theta=1e6,
    source="arXiv:2409.12191; hf",
))
