"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B] — MoE 48L, d=2048,
16H GQA kv=16, d_ff=1408 per expert, 64 experts top-6, vocab=163840."""
from repro_torch.configs import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import LMConfig


def make_config():
    return LMConfig(name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048,
                    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=163840,
                    n_experts=64, top_k=6, rope_theta=5e4)


def make_smoke_config():
    return LMConfig(name="moonshot-smoke", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=4, d_ff=48, vocab=256, n_experts=8, top_k=2,
                    q_chunk=8, kv_chunk=8)


def get():
    return ArchSpec(arch_id="moonshot-v1-16b-a3b", family="lm",
                    make_config=make_config,
                    make_smoke_config=make_smoke_config,
                    shapes=LM_SHAPES, fsdp=True,
                    notes="fine-grained MoE; FSDP x EP x TP")
