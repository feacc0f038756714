"""hubert-xlarge [audio]: 48L d=1280 16H (kv=16) ff=5120 vocab=504.

Encoder-only transformer (same arch as wav2vec2) [arXiv:2106.07447].
The conv waveform frontend is a STUB: inputs are precomputed frame
embeddings; training is masked-prediction CE over the 504-unit codebook.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab_size=504,
    causal=False, rope=False, qkv_bias=True,
    norm="layernorm", activation="gelu",
    embedding_inputs=True,
)
