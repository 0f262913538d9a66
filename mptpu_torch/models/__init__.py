"""Model assemblies of the port (counterpart of ``mptpu.models`` and of the
trainers in ``scripts/``; only the ported names)."""

from .audiooperator import (AudioOperator, band_pos_encode, envelope_loss,
                            generate_training_batch, train_audiooperator,
                            training_batch_from_draws)
from .codec_rate import rate_report
from .energy_overfit import EnergyOverfit, EnergyLoss, energy_step, overfit_energy
from .experiment import list_experiments, new_experiment, run_current
from .funcsong import FuncSong, count_parameters, song_pos_encoding, train_funcsong
from .holdout_anatomy import anatomy
from .inference import SIAMCodec, SIAMEncoding, quantize_events
from .instrument import (Note, PlayableInstrument, build_instrument, damped_sequential,
                         demo_phrase, repl)
from .mp_model import MatchingPursuit
from .mp_train import train_flat, train_multiband
from .multiband_parity import parity_trajectory
from .multiresolution import BandEncoder, ConvBandDecoder, DecoderShell, EncoderShell
from .overfit_diag import diag
from .overfit_refine_eval import refine_eval
from .overfit_stream_eval import stream_eval
from .phaseinvariance import (lsd_db, reconstruct_with_transform, run_phaseinvariance,
                              snr_db)
from .pointcloud import (CanonicalOrdering, GraphEdgeEmbedding, flattened_upper_triangular,
                         pairwise_differences)
from .report import make_overfit_report, make_report, make_songsplat_report
from .report_generalization import make_generalization_report
from .resonance_overfit import OverfitResonanceStack, ResonanceLoss, overfit_resonance
from .search import (BruteForceSearch, EventEmbedder, IndexedCorpus, build_index, index_corpus,
                     k_nearest, make_embedder)
from .siam import (Reservoir, SIAMModel, fade_tail, make_iterative_fn, make_random_sequence_fn,
                   make_streaming_fn, refine_event_alignment, refit_event_gains, siam_transform,
                   streaming_encode)
from .siam_overfit import SIAMOverfitStep, overfit_siam
from .siam_quality import run_siam_quality
from .siam_train import train_and_monitor
from .songsplat import (SongSplatModel, SongSplatRun, render_song, songsplat_loss, songsplat_step,
                        train_songsplat)
from .splat_overfit import (OverfitHierarchicalEvents, SplatDemo, SplatFit, overfit_splat,
                            splat_article, splat_loss_transform)
from .texture import synthesize_texture, texture_featurizer
from .textural import Splitter, TexturalModel, confidence_loss, train_textural
from .ssm_overfit import (InstrumentModel, OverfitControlPlane, SSMFit, generate_param_dict,
                          train_model_for_segment)
from .worker import IndexChunk, SynthPreset, render_preset, run_worker

__all__ = ["OverfitHierarchicalEvents", "SplatFit", "overfit_splat", "splat_loss_transform",
           "SIAMCodec", "SIAMEncoding", "quantize_events", "Reservoir", "SIAMModel", "fade_tail",
           "make_iterative_fn", "make_random_sequence_fn", "make_streaming_fn",
           "refine_event_alignment", "refit_event_gains", "siam_transform", "streaming_encode",
           "SIAMOverfitStep", "overfit_siam", "train_and_monitor", "InstrumentModel",
           "OverfitControlPlane", "SSMFit", "generate_param_dict", "train_model_for_segment",
           "Note", "PlayableInstrument", "build_instrument", "damped_sequential", "demo_phrase",
           "repl", "MatchingPursuit", "CanonicalOrdering", "GraphEdgeEmbedding",
           "flattened_upper_triangular", "pairwise_differences", "BruteForceSearch",
           "EventEmbedder", "IndexedCorpus", "build_index", "index_corpus", "k_nearest",
           "make_embedder", "SongSplatModel", "SongSplatRun", "render_song", "songsplat_loss",
           "songsplat_step", "train_songsplat", "AudioOperator", "band_pos_encode",
           "envelope_loss", "generate_training_batch", "train_audiooperator",
           "training_batch_from_draws", "FuncSong", "count_parameters", "song_pos_encoding",
           "train_funcsong", "BandEncoder", "ConvBandDecoder", "DecoderShell", "EncoderShell",
           "Splitter", "TexturalModel", "confidence_loss", "train_textural", "lsd_db",
           "reconstruct_with_transform", "run_phaseinvariance", "snr_db",
           "OverfitResonanceStack", "ResonanceLoss", "overfit_resonance", "synthesize_texture",
           "texture_featurizer", "EnergyOverfit", "EnergyLoss", "energy_step",
           "overfit_energy", "rate_report", "train_flat", "train_multiband", "run_siam_quality",
           "SplatDemo", "splat_article", "refine_eval", "diag", "stream_eval", "anatomy",
           "make_report", "make_overfit_report", "make_songsplat_report",
           "make_generalization_report", "SynthPreset", "IndexChunk", "render_preset",
           "run_worker", "new_experiment", "list_experiments", "run_current",
           "parity_trajectory"]
