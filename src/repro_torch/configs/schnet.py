"""schnet [arXiv:1706.08566] — 3 interactions, d=64, rbf=300, cutoff=10."""
from repro_torch.configs import GNN_SHAPES, ArchSpec
from repro_torch.models.gnn import SchNetConfig


def make_config():
    return SchNetConfig(name="schnet", n_interactions=3, d_hidden=64,
                        n_rbf=300, cutoff=10.0)


def make_smoke_config():
    return SchNetConfig(name="schnet-smoke", n_interactions=2, d_hidden=16,
                        n_rbf=8, cutoff=5.0)


def get():
    return ArchSpec(arch_id="schnet", family="gnn", make_config=make_config,
                    make_smoke_config=make_smoke_config, shapes=GNN_SHAPES)
