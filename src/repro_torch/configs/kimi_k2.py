"""kimi-k2-1t-a32b — trillion-param MoE, 61L, d_model 7168, 64H GQA(kv=8),
expert d_ff 2048, vocab 163840, 384 experts top-8. [arXiv:2501.kimi2;
unverified paper-table]. Approximation: every layer is MoE (the real model
has a dense first layer + 1 shared expert)."""
from repro_torch.configs import register
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = register(ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab=163840, head_dim=128,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048),
    source="arXiv:2501.kimi2; unverified",
))
