"""qwen3-8b [dense] 36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936
— qk_norm, GQA [hf:Qwen/Qwen3-8B].

8 KV heads don't divide the 16-way model axis: the decode cache shards on
the sequence dim instead (XLA partial-softmax collectives).
long_500k skipped: pure full attention.
"""
import torch

from repro_torch.models.transformer import TransformerConfig

from .lm_common import LMArch

FULL = TransformerConfig(
    name="qwen3-8b", n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    head_dim=128, d_ff=12288, vocab=151936, qk_norm=True, attn_chunk=1024,
)
REDUCED = TransformerConfig(
    name="qwen3-8b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab=256, qk_norm=True, dtype=torch.float32,
    remat=False,
)
ARCH = LMArch("qwen3-8b", FULL, REDUCED,
              long_ctx_skip="pure full-attention arch; skipped per "
                            "assignment rules",
              kv_shardable=False)
