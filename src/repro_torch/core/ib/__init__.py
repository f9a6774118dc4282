"""Mutual-information estimators for the information-bottleneck analysis
(copies of ``repro.core.ib``; numpy and scipy only)."""
from repro_torch.core.ib import binning, gcmi, info_plane, kde

__all__ = ["binning", "gcmi", "info_plane", "kde"]
