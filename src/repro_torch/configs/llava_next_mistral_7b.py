"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

VLM: the Mistral-7B language trunk consumes pre-projected anyres patch
embeddings from the (stubbed) vision tower, models/frontend.py.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", arch_type="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    attention="gqa", use_rope=True, rope_theta=1e4,
    mlp="swiglu", norm="rmsnorm",
    modality="vision", num_patches=576,   # anyres base tile = 24x24 patches
    max_seq_len=32768,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512, num_patches=16, max_seq_len=512,
)
