"""The paper's own experiment configuration: synthetic MSMarco-scale corpus
+ WindTunnel pipeline + semantic-search evaluation (Fig. 5, Tables I/II).
"""
import dataclasses

from repro_torch.core.pipeline import WindTunnelConfig
from repro_torch.retrieval.encoder import EncoderConfig


@dataclasses.dataclass(frozen=True)
class WindTunnelExperimentConfig:
    # corpus (calibrated — DESIGN.md §6, EXPERIMENTS.md §Repro)
    num_queries: int = 1280
    qrels_per_query: int = 32
    num_topics: int = 96
    aux_fraction: float = 2.0
    vocab_size: int = 3072
    query_len: int = 24
    # Fig. 4 corpus (degree-law calibration: gamma ~ 2.8-3.0)
    fig4_num_queries: int = 20000
    fig4_qrels_per_query: int = 3
    # pipeline
    windtunnel: WindTunnelConfig = WindTunnelConfig(
        tau_quantile=0.5, fanout=16, lp_rounds=5)
    sample_fraction: float = 0.15    # of judged entities (paper: 100K/corpus)
    # embedder
    encoder: EncoderConfig = EncoderConfig(vocab_size=3072)
    encoder_steps: int = 400
    seed: int = 0


CONFIG = WindTunnelExperimentConfig()
