"""dlrm-mlperf [recsys]: n_dense=13 n_sparse=26 embed_dim=128
bot_mlp=13-512-256-128 top_mlp=1024-1024-512-256-1, dot interaction —
MLPerf DLRM benchmark config (Criteo 1TB cardinalities).
[arXiv:1906.00091; paper]
"""
from repro_torch.configs import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import CRITEO_TB_CARDS, RecsysConfig


def make_config() -> RecsysConfig:
    return RecsysConfig(
        arch="dlrm", n_dense=13, n_sparse=26, embed_dim=128,
        vocab_sizes=CRITEO_TB_CARDS,
        bot_mlp=(512, 256, 128), top_mlp=(1024, 1024, 512, 256, 1))


def make_reduced() -> RecsysConfig:
    return RecsysConfig(
        arch="dlrm", n_dense=13, n_sparse=26, embed_dim=16,
        vocab_sizes=tuple([64] * 26), bot_mlp=(32, 16), top_mlp=(32, 16, 1))


SPEC = ArchSpec(
    arch_id="dlrm-mlperf", family="recsys",
    make_config=make_config, make_reduced=make_reduced,
    shapes=RECSYS_SHAPES,
    notes="188M embedding rows x 128 -> 96GB fp32, row-sharded over 'model'",
)
