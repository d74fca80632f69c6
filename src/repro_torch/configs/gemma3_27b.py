"""gemma3-27b [dense] 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global, 128k context [hf:google/gemma-3-1b-pt].

5 local (sliding-window 1024) layers per global layer; qk-norm as in the
released model.  The hybrid local:global pattern makes this the one LM arch
that RUNS long_500k (decode against a 512k cache: global layers attend the
full cache, local layers a 1024 window).
"""
import torch

from repro_torch.models.transformer import TransformerConfig

from .lm_common import LMArch

FULL = TransformerConfig(
    name="gemma3-27b", n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
    head_dim=128, d_ff=21504, vocab=262144, qk_norm=True,
    window=1024, local_ratio=5, attn_chunk=1024,
)
REDUCED = TransformerConfig(
    name="gemma3-27b-smoke", n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab=256, qk_norm=True, window=8, local_ratio=5,
    dtype=torch.float32, remat=False,
)
ARCH = LMArch("gemma3-27b", FULL, REDUCED, long_ctx_skip=None,
              kv_shardable=True)
