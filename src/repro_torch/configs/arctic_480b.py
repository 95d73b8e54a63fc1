"""arctic-480b — MoE 128e top-2 with a parallel dense residual branch, 35L,
d_model 7168, 56H GQA(kv=8), d_ff 4864, vocab 32000.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = register(ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab=32000, head_dim=128,
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                  dense_residual_ff=4864),
    source="hf:Snowflake/snowflake-arctic-base; hf",
))
