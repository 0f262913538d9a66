"""Model assemblies of the port (counterpart of ``mptpu.models``; only the
ported names)."""

from .splat_overfit import OverfitHierarchicalEvents, SplatFit, overfit_splat, splat_loss_transform

__all__ = ["OverfitHierarchicalEvents", "SplatFit", "overfit_splat", "splat_loss_transform"]
