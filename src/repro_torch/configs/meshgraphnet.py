"""meshgraphnet [arXiv:2010.03409] — 15 layers, d=128, sum agg, 2-layer MLPs."""
from repro_torch.configs import GNN_SHAPES, ArchSpec
from repro_torch.models.gnn import MGNConfig


def make_config(d_in_node: int = 8):
    return MGNConfig(name="meshgraphnet", n_layers=15, d_hidden=128,
                     mlp_layers=2, d_in_node=d_in_node, d_in_edge=4, d_out=3)


def make_smoke_config():
    return MGNConfig(name="mgn-smoke", n_layers=3, d_hidden=16, mlp_layers=2,
                     d_in_node=8, d_in_edge=4, d_out=3)


def get():
    return ArchSpec(arch_id="meshgraphnet", family="gnn",
                    make_config=make_config,
                    make_smoke_config=make_smoke_config, shapes=GNN_SHAPES)
