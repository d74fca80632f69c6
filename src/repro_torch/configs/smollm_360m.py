"""smollm-360m [dense] 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
— llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf].

15 heads / 5 KV heads do not divide the 16-way model axis: attention weights
shard FSDP-only; d_ff (2560) and vocab (49152) are tensor-parallel.
long_500k skipped: pure full attention (assignment rule; DESIGN.md §4).
"""
import torch

from repro_torch.models.transformer import TransformerConfig

from .lm_common import LMArch

FULL = TransformerConfig(
    name="smollm-360m", n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    head_dim=64, d_ff=2560, vocab=49152, attn_chunk=1024,
)
REDUCED = TransformerConfig(
    name="smollm-360m-smoke", n_layers=2, d_model=60, n_heads=3,
    n_kv_heads=1, head_dim=20, d_ff=96, vocab=128, dtype=torch.float32,
    remat=False,
)
ARCH = LMArch("smollm-360m", FULL, REDUCED,
              long_ctx_skip="pure full-attention arch (no sub-quadratic "
                            "path); skipped per assignment rules",
              kv_shardable=False)
