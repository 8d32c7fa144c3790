"""mace [gnn]: n_layers=2 d_hidden=128 l_max=2 correlation_order=3 n_rbf=8,
E(3)-ACE higher-order equivariant message passing. [arXiv:2206.07697; paper]

WindTunnel applicability: NONE (no QRel structure on molecular graphs) —
implemented without the technique per DESIGN.md §5; shares the segment-sum
message-passing substrate with core label propagation.
"""
from repro_torch.configs import ArchSpec, GNN_SHAPES
from repro_torch.models.mace import MACEConfig


def make_config() -> MACEConfig:
    return MACEConfig(n_layers=2, channels=128, l_max=2, correlation=3,
                      n_rbf=8, d_feat=16)


def make_reduced() -> MACEConfig:
    return MACEConfig(n_layers=2, channels=8, l_max=2, correlation=3,
                      n_rbf=4, d_feat=8)


SPEC = ArchSpec(
    arch_id="mace", family="gnn",
    make_config=make_config, make_reduced=make_reduced,
    shapes=GNN_SHAPES,
    notes="d_feat per shape overrides config (full_graph_sm 1433, "
          "ogb_products 100); minibatch_lg uses the real neighbour sampler",
)
