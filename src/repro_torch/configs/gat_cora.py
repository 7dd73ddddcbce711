"""gat-cora [arXiv:1710.10903] — 2L, d_hidden=8, 8 heads, attn aggregator."""
from repro_torch.configs import GNN_SHAPES, ArchSpec
from repro_torch.models.gnn import GATConfig


def make_config(d_in: int = 1433, n_classes: int = 7):
    return GATConfig(name="gat-cora", n_layers=2, d_hidden=8, n_heads=8,
                     d_in=d_in, n_classes=n_classes)


def make_smoke_config():
    return GATConfig(name="gat-smoke", n_layers=2, d_hidden=4, n_heads=2,
                     d_in=16, n_classes=3)


def get():
    return ArchSpec(arch_id="gat-cora", family="gnn", make_config=make_config,
                    make_smoke_config=make_smoke_config, shapes=GNN_SHAPES)
