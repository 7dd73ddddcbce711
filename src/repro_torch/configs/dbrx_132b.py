"""dbrx-132b [hf:databricks/dbrx-base] — MoE 40L, d=6144, 48H GQA kv=8,
d_ff=10752 per expert, 16 experts top-4, vocab=100352."""
from repro_torch.configs import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import LMConfig


def make_config():
    return LMConfig(name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48,
                    n_kv_heads=8, d_ff=10752, vocab=100352, n_experts=16,
                    top_k=4, rope_theta=5e5)


def make_smoke_config():
    return LMConfig(name="dbrx-smoke", n_layers=2, d_model=96, n_heads=6,
                    n_kv_heads=2, d_ff=168, vocab=256, n_experts=4, top_k=2,
                    q_chunk=8, kv_chunk=8)


def get():
    return ArchSpec(arch_id="dbrx-132b", family="lm",
                    make_config=make_config,
                    make_smoke_config=make_smoke_config,
                    shapes=LM_SHAPES, fsdp=True,
                    notes="132B params: FSDP x TP/EP mandatory (DESIGN §7)")
