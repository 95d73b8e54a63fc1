"""whisper-small — encoder-decoder audio backbone, 12L enc + 12L dec,
d_model 768, 12H, d_ff 3072, vocab 51865. The conv/mel frontend is a STUB:
input_specs() supplies precomputed 1500-frame encoder embeddings.
[arXiv:2212.04356; unverified]"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchConfig, EncDecConfig

CONFIG = register(ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=51865, head_dim=64, norm="layernorm", mlp="gelu",
    enc_dec=EncDecConfig(n_encoder_layers=12, encoder_seq=1500),
    source="arXiv:2212.04356; unverified",
))
