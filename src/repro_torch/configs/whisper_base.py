"""Whisper-base [arXiv:2212.04356] — encoder-decoder; conv/mel frontend STUBBED.

The port models the transformer backbone only: the steps' ``input_specs``
and ``serve_encdec`` feed precomputed post-conv frame embeddings (B,
1500, 512).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", arch_type="audio", source="arXiv:2212.04356",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865,
    attention="gqa", use_rope=False,     # whisper uses learned/sinusoidal pos
    attn_bias=True, mlp_bias=True,
    is_encoder_decoder=True, encoder_layers=6, encoder_seq_len=1500,
    modality="audio",
    mlp="gelu", norm="layernorm",
    max_seq_len=448,
)

SMOKE = CONFIG.with_(
    num_layers=2, encoder_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512, encoder_seq_len=64, max_seq_len=128,
)
