"""Model assemblies of the port (counterpart of ``mptpu.models``; only the
ported names)."""

from .inference import SIAMCodec, SIAMEncoding, quantize_events
from .siam import (SIAMModel, fade_tail, make_iterative_fn, make_streaming_fn,
                   refine_event_alignment, refit_event_gains, siam_transform, streaming_encode)
from .splat_overfit import OverfitHierarchicalEvents, SplatFit, overfit_splat, splat_loss_transform
from .ssm_overfit import (InstrumentModel, OverfitControlPlane, SSMFit, generate_param_dict,
                          train_model_for_segment)

__all__ = ["OverfitHierarchicalEvents", "SplatFit", "overfit_splat", "splat_loss_transform",
           "SIAMCodec", "SIAMEncoding", "quantize_events", "SIAMModel", "fade_tail",
           "make_iterative_fn", "make_streaming_fn", "refine_event_alignment",
           "refit_event_gains", "siam_transform", "streaming_encode", "InstrumentModel",
           "OverfitControlPlane", "SSMFit", "generate_param_dict", "train_model_for_segment"]
