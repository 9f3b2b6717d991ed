"""StarCoder2-3B [arXiv:2402.19173] — dense, GQA kv=2, RoPE, GeLU MLP w/ bias."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", arch_type="dense", source="arXiv:2402.19173",
    num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
    d_ff=12288, vocab_size=49152,
    attention="gqa", use_rope=True, rope_theta=1e5,
    attn_bias=True, mlp_bias=True, mlp="gelu", norm="layernorm",
    max_seq_len=16384,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512, max_seq_len=512,
)
