"""DeepSeek-V2 236B [arXiv:2405.04434] — MLA (kv_lora=512) + MoE 160e top-6 + 2 shared."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", arch_type="moe", source="arXiv:2405.04434",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=12288,                      # dense layers (first_dense_layers)
    vocab_size=102400,
    attention="mla", use_rope=True, rope_theta=1e4,
    kv_lora_rank=512, q_lora_rank=1536,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    moe=True, num_experts=160, num_shared_experts=2, top_k=6,
    moe_d_ff=1536, first_dense_layers=1, moe_every=1,
    mlp="swiglu", norm="rmsnorm",
    max_seq_len=131072,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
    d_ff=512, vocab_size=512,
    kv_lora_rank=64, q_lora_rank=96,
    qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
    num_experts=4, num_shared_experts=1, top_k=2, moe_d_ff=128,
    first_dense_layers=1, max_seq_len=512,
)
