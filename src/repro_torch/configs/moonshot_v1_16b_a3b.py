"""moonshot-v1-16b-a3b [moe] 48L d_model=2048 16H (GQA kv=16) expert_ff=1408
vocab=163840, MoE 64 experts top-6 (+2 shared) — kimi/moonlight lineage
[hf:moonshotai/Moonlight-16B-A3B].

Experts shard on the model axis (EP=TP); dispatch is the linear-cost
sort-based scheme (models/transformer.moe_ffn). long_500k skipped: full
attention.
"""
import torch

from repro_torch.models.transformer import TransformerConfig

from .lm_common import LMArch

FULL = TransformerConfig(
    name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
    n_kv_heads=16, head_dim=128, d_ff=1408, vocab=163840,
    n_experts=64, n_shared=2, top_k=6, d_expert=1408, attn_chunk=1024,
)
REDUCED = TransformerConfig(
    name="moonshot-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=32, vocab=256, n_experts=8, n_shared=2, top_k=2,
    d_expert=32, dtype=torch.float32, remat=False,
)
ARCH = LMArch("moonshot-v1-16b-a3b", FULL, REDUCED,
              long_ctx_skip="pure full-attention arch; skipped per "
                            "assignment rules",
              kv_shardable=True)
