"""Yule-Simon EM fit (paper §III-A, following Roberts & Roberts [10]), port
of ``repro/core/yule_simon.py``.

MSMarco passage node degrees follow a Yule-Simon discrete power law,
p(k; rho) = rho * B(k, rho + 1), k >= 1, with tail exponent gamma = rho + 1.

  E-step: E[w_i] = psi(rho + 1 + k_i) - psi(rho + 1)
  M-step: rho <- n / sum_i E[w_i]
  se(rho_hat) = I(rho_hat)^{-1/2},
  I(rho) = n / rho^2 - sum_i [psi'(rho + 1) - psi'(rho + 1 + k_i)].

``lax.while_loop`` becomes a Python loop that reads the convergence test
back to the host once per iteration.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class YuleSimonFit(NamedTuple):
    rho: torch.Tensor
    gamma: torch.Tensor      # power-law exponent rho + 1
    stderr: torch.Tensor
    log_lik: torch.Tensor
    iters: int


def log_pmf(k: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """log p(k; rho) = log rho + log B(k, rho + 1)."""
    k = k.to(torch.float32)
    return (torch.log(rho) + torch.lgamma(k) + torch.lgamma(rho + 1.0)
            - torch.lgamma(k + rho + 1.0))


def fit_em(degrees: torch.Tensor, weights: Optional[torch.Tensor] = None, *,
           rho0: float = 1.0, max_iters: int = 200,
           tol: float = 1e-7) -> YuleSimonFit:
    """EM fit of rho on observed degrees k_i >= 1 (``weights``: optional
    multiplicities, masked entries weight 0)."""
    k = degrees.to(torch.float32)
    wt = torch.ones_like(k) if weights is None else weights.to(torch.float32)
    wt = torch.where(k >= 1.0, wt, 0.0)
    k = torch.clamp(k, min=1.0)
    n = wt.sum()
    rho = torch.tensor(rho0, dtype=torch.float32, device=k.device)
    iters = 0
    while iters < max_iters:
        e_w = torch.digamma(rho + 1.0 + k) - torch.digamma(rho + 1.0)
        new_rho = n / (wt * e_w).sum()
        delta = float(torch.abs(new_rho - rho))
        rho = new_rho
        iters += 1
        if not delta > tol:
            break
    fisher = (n / rho ** 2
              - (wt * (torch.polygamma(1, rho + 1.0)
                       - torch.polygamma(1, rho + 1.0 + k))).sum())
    stderr = torch.where(fisher > 0, 1.0 / torch.sqrt(fisher), torch.nan)
    ll = (wt * log_pmf(k, rho)).sum()
    return YuleSimonFit(rho, rho + 1.0, stderr, ll, iters)

