"""dimenet [arXiv:2003.03123] — 6 blocks, d=128, bilinear=8, spherical=7,
radial=6."""
from repro_torch.configs import GNN_SHAPES, ArchSpec
from repro_torch.models.gnn import DimeNetConfig


def make_config():
    return DimeNetConfig(name="dimenet", n_blocks=6, d_hidden=128,
                         n_bilinear=8, n_spherical=7, n_radial=6)


def make_smoke_config():
    return DimeNetConfig(name="dimenet-smoke", n_blocks=2, d_hidden=16,
                         n_bilinear=4, n_spherical=3, n_radial=4)


def get():
    return ArchSpec(arch_id="dimenet", family="gnn", make_config=make_config,
                    make_smoke_config=make_smoke_config, shapes=GNN_SHAPES)
