from repro_torch.kernels.label_prop.ops import LP_ROUND, label_prop_round

__all__ = ["LP_ROUND", "label_prop_round"]
