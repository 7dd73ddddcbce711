"""qwen3-1.7b [hf:Qwen/Qwen3 family] — 28L, d=2048, 16H GQA kv=8, d_ff=6144,
vocab=151936, qk_norm."""
from repro_torch.configs import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import LMConfig


def make_config():
    return LMConfig(name="qwen3-1.7b", n_layers=28, d_model=2048, n_heads=16,
                    n_kv_heads=8, d_ff=6144, vocab=151936, qk_norm=True,
                    rope_theta=1e6, tie_embeddings=True)


def make_smoke_config():
    return LMConfig(name="qwen3-1.7b-smoke", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, d_ff=96, vocab=256,
                    qk_norm=True, q_chunk=8, kv_chunk=8, tie_embeddings=True)


def get():
    return ArchSpec(arch_id="qwen3-1.7b", family="lm",
                    make_config=make_config,
                    make_smoke_config=make_smoke_config,
                    shapes=LM_SHAPES, fsdp=False,
                    notes="qk_norm on q/k heads (per-head RMSNorm)")
