"""deepseek-v2-lite-16b [moe] 27L d_model=2048 16H d_ff(expert)=1408
vocab=102400, MoE 64 routed top-6 + 2 shared, MLA kv_lora=512
[arXiv:2405.04434].

MLA: queries carry 128 nope + 64 rope dims; KV is compressed to a 512-dim
latent + shared rope key — the decode cache stores only (latent, rope key),
the arch's memory contribution.  long_500k skipped: MLA compresses KV
*storage*, attention is still full.
"""
import torch

from repro_torch.models.transformer import TransformerConfig

from .lm_common import LMArch

FULL = TransformerConfig(
    name="deepseek-v2-lite-16b", n_layers=27, d_model=2048, n_heads=16,
    n_kv_heads=16, head_dim=128, d_ff=1408, vocab=102400,
    n_experts=64, n_shared=2, top_k=6, d_expert=1408,
    kv_lora=512, rope_head_dim=64, v_head_dim=128, attn_chunk=1024,
)
REDUCED = TransformerConfig(
    name="deepseek-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=32, vocab=256, n_experts=8, n_shared=2, top_k=2,
    d_expert=32, kv_lora=32, rope_head_dim=8, v_head_dim=16,
    dtype=torch.float32, remat=False,
)
ARCH = LMArch("deepseek-v2-lite-16b", FULL, REDUCED,
              long_ctx_skip="full attention (MLA compresses KV storage, "
                            "not attention cost); skipped per assignment "
                            "rules",
              kv_shardable=True)
