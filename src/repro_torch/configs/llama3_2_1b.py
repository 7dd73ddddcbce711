"""llama3.2-1b [hf:meta-llama/Llama-3.2-1B] — 16L, d=2048, 32H GQA kv=8,
d_ff=8192, vocab=128256."""
from repro_torch.configs import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import LMConfig


def make_config():
    return LMConfig(name="llama3.2-1b", n_layers=16, d_model=2048, n_heads=32,
                    n_kv_heads=8, d_ff=8192, vocab=128256, rope_theta=5e5,
                    tie_embeddings=True)


def make_smoke_config():
    return LMConfig(name="llama3.2-1b-smoke", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                    q_chunk=8, kv_chunk=8, tie_embeddings=True)


def get():
    return ArchSpec(arch_id="llama3.2-1b", family="lm",
                    make_config=make_config,
                    make_smoke_config=make_smoke_config,
                    shapes=LM_SHAPES, fsdp=False)
