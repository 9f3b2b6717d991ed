"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01] — dense GQA kv=8, no-bias."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b", arch_type="dense",
    source="hf:CohereForAI/c4ai-command-r-v01",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22528, vocab_size=256000,
    attention="gqa", use_rope=True, rope_theta=8e6,
    attn_bias=False, mlp_bias=False,
    mlp="swiglu", norm="layernorm", tie_embeddings=True,
    max_seq_len=131072,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512, max_seq_len=512,
)
