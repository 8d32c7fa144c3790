"""End-to-end semantic-search experiment (port of
``repro/retrieval/experiment.py``; paper §III-B, Tables I & II).

Pipeline per sample type (full corpus / uniform random / WindTunnel):
  1. restrict the corpus to the sampled entities,
  2. index their embeddings with any registered retrieval engine (the
     default ivfflat is the paper's pgvector index),
  3. run the sample's associated queries through ANN top-k,
  4. report precision@3 against the QRels and the query density rho_q.

The embedding model is trained once on (query, passage) pairs, so the
sampling methods are compared on the same embedding geometry, as in the
paper. Every entry point takes a ``device`` and runs on the card unless the
caller asks for the CPU. On the card the encoder embeds through the
flash-attention kernel, the WindTunnel draw's label propagation through
the LP kernel and the ivfflat probe through the gathered top-k kernel.
The WindTunnel draw goes through a ``SamplerSession`` (the reference's
deprecated ``run_windtunnel`` wraps the same session), its spec the
caller's or the reference's ``wt_config`` mapped by
``SamplerSpec.from_config``; the LP engine is left to the device's
default unless the spec names one.

Spans (``obs/trace``): ``table1.train``, ``table1.embed``,
``table1.sample`` and ``table1.search``.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import (SamplerSession, SamplerSpec, WindTunnelConfig,
                              associated_queries, prng, query_density)
from repro_torch.core.graph_builder import QRelTable
from repro_torch.data.batching import TokenBatcher
from repro_torch.data.synthetic import SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.obs import trace
from repro_torch.retrieval.encoder import (EncoderConfig, contrastive_loss,
                                           embed_corpus, init_encoder)
from repro_torch.retrieval.metrics import precision_at_k, qrel_set
from repro_torch.retrieval.search_core import SearchConfig, SearchSession
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, tree_leaves,
                                         tree_unflatten)

log = logging.getLogger("repro_torch.retrieval.experiment")


def train_encoder(corpus: SyntheticCorpus, cfg: EncoderConfig, *,
                  steps: int = 300, batch_size: int = 64, lr: float = 1e-3,
                  seed: int = 0, log_every: int = 100, device="cuda"):
    """Train the encoder with in-batch InfoNCE and the reference's AdamW;
    returns (params on ``device``, per-step losses). As in the reference,
    each batch keeps only its query and passage tokens: the mined hard
    negatives are drawn and not used."""
    dev = resolve_device(device)
    params = init_encoder(prng.prng_key(seed), cfg, device=dev)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=20, total_steps=steps,
                          weight_decay=0.01)
    state = adamw_init(params)
    batcher = TokenBatcher(corpus, batch_size, seed=seed)

    losses = []
    for step in range(steps):
        batch = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in
                 batcher.contrastive_batch(step).items()
                 if k in ("query_tokens", "passage_tokens")}
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        params = tree_unflatten(params, leaves)
        loss = contrastive_loss(params, batch, cfg)
        grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
        with torch.no_grad():
            params, state, _ = adamw_update(grads, state, params, opt_cfg)
        losses.append(float(loss.detach()))
        if log_every and step % log_every == 0:
            log.info("  encoder step %d: loss %.4f", step, losses[-1])
    return params, losses


@dataclasses.dataclass
class SearchResult:
    name: str
    p_at_3: float
    rho_q: float
    n_entities: int
    n_queries: int


def evaluate_sample(name: str, corpus: SyntheticCorpus,
                    entity_vecs: np.ndarray, query_vecs: np.ndarray,
                    entity_mask: Optional[np.ndarray], *,
                    k: int = 3, n_lists: int = 64, nprobe: int = 8,
                    max_queries: int = 2048, seed: int = 0,
                    engine: str = "ivfflat",
                    query_chunk: int = 256,
                    search: Optional[SearchConfig] = None,
                    device="cuda") -> SearchResult:
    """entity_mask None -> full corpus; ``engine`` names any registered
    retrieval engine (n_lists/nprobe apply to ivfflat only).  ``search``
    carries backend options into the search core; its engine field is
    overridden by ``engine``."""
    dev = resolve_device(device)
    n_ent = corpus.num_entities
    mask = (np.ones(n_ent, bool) if entity_mask is None
            else np.array(entity_mask, bool))
    kept_ids = np.nonzero(mask)[0]
    # queries associated with the sample (>=1 relevant kept entity), at
    # most max_queries of them (the reference's draw, in sorted order)
    assoc, qids = associated_queries(corpus.qrels, mask,
                                     num_queries=corpus.num_queries,
                                     max_queries=max_queries, seed=seed)

    opts = dict((search.engine_opts or {}) if search else {})
    if engine == "ivfflat":  # honour the legacy tuning knobs
        opts.update(n_lists=n_lists, nprobe=nprobe)
    cfg = dataclasses.replace(search or SearchConfig(), engine=engine,
                              query_chunk=query_chunk,
                              engine_opts=opts or None)
    session = SearchSession(np.asarray(entity_vecs)[kept_ids], cfg,
                            key=prng.prng_key(seed), ids_map=kept_ids,
                            device=dev)
    global_ids = session.search(np.asarray(query_vecs)[qids], k=k)

    qr = corpus.qrels
    p3 = precision_at_k(global_ids, qids,
                        qrel_set(qr.query_ids, qr.entity_ids, qr.valid), k=k)

    rho = float(query_density(
        QRelTable(*corpus.qrels).to(dev), torch.tensor(mask, device=dev),
        torch.tensor(assoc, device=dev), num_queries=corpus.num_queries,
        num_entities=n_ent))
    return SearchResult(name, p3, rho, int(kept_ids.size), int(qids.size))


def run_table1_experiment(corpus: SyntheticCorpus, *,
                          encoder_cfg: Optional[EncoderConfig] = None,
                          encoder_steps: int = 300,
                          wt_config: Optional[WindTunnelConfig] = None,
                          sampler: Optional[SamplerSpec] = None,
                          sample_size: Optional[int] = None,
                          seed: int = 0,
                          verbose: bool = True,
                          device="cuda") -> Dict[str, SearchResult]:
    """Reproduces Tables I & II: full vs uniform vs WindTunnel.

    The WindTunnel draw takes the reference's ``wt_config`` or the port's
    ``sampler`` spec, not both (``SamplerSpec.from_config`` maps one to the
    other; the draw is ``run_windtunnel``'s): by default the reference's
    WindTunnel settings (tau quantile 0.5, fanout 16, 5 LP rounds, max
    degree 32) at ``sample_size`` and ``seed``, with the device's LP
    engine."""
    if wt_config is not None and sampler is not None:
        raise ValueError("run_table1_experiment takes wt_config or sampler, "
                         "not both")
    dev = resolve_device(device)
    enc_cfg = encoder_cfg or EncoderConfig(vocab_size=corpus.vocab_size)
    level = logging.INFO if verbose else logging.DEBUG
    log.log(level, "training embedding model...")
    with trace.span("table1.train", steps=encoder_steps):
        params, _ = train_encoder(corpus, enc_cfg, steps=encoder_steps,
                                  seed=seed, log_every=100 if verbose else 0,
                                  device=dev)
    log.log(level, "embedding corpus + queries...")
    with trace.span("table1.embed", n=corpus.num_entities,
                    q=corpus.num_queries):
        entity_vecs = embed_corpus(params, corpus.passage_tokens, enc_cfg,
                                   device=dev)
        query_vecs = embed_corpus(params, corpus.query_tokens, enc_cfg,
                                  device=dev)

    # --- WindTunnel sample ---
    # 15% of the JUDGED corpus by default; both samples draw from the
    # qrel'd (primary) entities, and only the full-corpus row keeps the
    # unjudged auxiliary entities.
    if sample_size is None:
        sample_size = int(0.15 * corpus.num_primary)
    if wt_config is not None:
        sampler = SamplerSpec.from_config(wt_config)
    spec = sampler or SamplerSpec(tau_quantile=0.5, fanout=16, lp_rounds=5,
                                  target_size=sample_size, seed=seed)
    with trace.span("table1.sample", target=sample_size):
        session = SamplerSession(corpus.qrels,
                                 num_queries=corpus.num_queries,
                                 num_entities=corpus.num_entities,
                                 spec=spec, device=dev)
        wt_mask = session.draw().entity_mask.cpu().numpy()
    wt_size = int(wt_mask.sum())

    # --- uniform sample of the judged entities, same size ---
    rate = wt_size / corpus.num_primary
    rng = np.random.default_rng(seed + 7)
    uni_mask = np.zeros(corpus.num_entities, bool)
    uni_mask[:corpus.num_primary] = rng.random(corpus.num_primary) < rate

    results = {}
    with trace.span("table1.search"):
        for name, mask in [("full", None), ("uniform", uni_mask),
                           ("windtunnel", wt_mask)]:
            results[name] = evaluate_sample(
                name, corpus, entity_vecs, query_vecs, mask, seed=seed,
                device=dev)
            r = results[name]
            log.log(level, "  %-12s p@3=%.3f rho_q=%.3f entities=%d "
                    "queries=%d", name, r.p_at_3, r.rho_q, r.n_entities,
                    r.n_queries)
    return results
