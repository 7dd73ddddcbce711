"""minicpm-2b [arXiv:2404.06395; hf] — dense, 40L, d=2304, 36H (GQA kv=36),
d_ff=5760, vocab=122753; WSD schedule (llama-like)."""
from repro_torch.configs import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import LMConfig


def make_config():
    return LMConfig(name="minicpm-2b", n_layers=40, d_model=2304, n_heads=36,
                    n_kv_heads=36, d_ff=5760, vocab=122753, rope_theta=1e4,
                    tie_embeddings=True)


def make_smoke_config():
    return LMConfig(name="minicpm-2b-smoke", n_layers=2, d_model=72,
                    n_heads=6, n_kv_heads=6, d_ff=144, vocab=256,
                    q_chunk=8, kv_chunk=8, tie_embeddings=True)


def get():
    return ArchSpec(arch_id="minicpm-2b", family="lm",
                    make_config=make_config,
                    make_smoke_config=make_smoke_config,
                    shapes=LM_SHAPES, fsdp=False,
                    notes="WSD schedule; tied embeddings per paper")
