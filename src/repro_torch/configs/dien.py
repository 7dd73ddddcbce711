"""dien [arXiv:1809.03672] — embed_dim=18, seq_len=100, gru_dim=108,
mlp=200-80, AUGRU interaction."""
from repro_torch.configs import RECSYS_SHAPES, ArchSpec
from repro_torch.models.dien import DIENConfig


def make_config():
    return DIENConfig(name="dien", embed_dim=18, seq_len=100, gru_dim=108,
                      mlp_dims=(200, 80), n_items=1_000_000, n_cates=10_000,
                      n_user_feats=100_000, user_hot=8)


def make_smoke_config():
    return DIENConfig(name="dien-smoke", embed_dim=8, seq_len=12, gru_dim=16,
                      mlp_dims=(24, 8), n_items=512, n_cates=32,
                      n_user_feats=128, user_hot=4)


def get():
    return ArchSpec(arch_id="dien", family="recsys", make_config=make_config,
                    make_smoke_config=make_smoke_config, shapes=RECSYS_SHAPES)
