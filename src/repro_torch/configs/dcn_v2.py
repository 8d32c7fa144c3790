"""dcn-v2 [recsys]: n_dense=13 n_sparse=26 embed_dim=16 n_cross_layers=3
mlp=1024-1024-512, cross interaction. [arXiv:2008.13535; paper]
"""
from repro_torch.configs import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import CRITEO_KAGGLE_CARDS, RecsysConfig


def make_config() -> RecsysConfig:
    return RecsysConfig(
        arch="dcn_v2", n_dense=13, n_sparse=26, embed_dim=16,
        vocab_sizes=CRITEO_KAGGLE_CARDS,
        n_cross_layers=3, mlp_dims=(1024, 1024, 512))


def make_reduced() -> RecsysConfig:
    return RecsysConfig(
        arch="dcn_v2", n_dense=13, n_sparse=26, embed_dim=8,
        vocab_sizes=tuple([64] * 26), n_cross_layers=2, mlp_dims=(32, 16))


SPEC = ArchSpec(
    arch_id="dcn-v2", family="recsys",
    make_config=make_config, make_reduced=make_reduced,
    shapes=RECSYS_SHAPES,
)
