"""The L1 sparse-coding layer (counterpart of ``mptpu.sparse``): the top-k
family, greedy matching pursuit, naive and fast, with its CUDA kernels,
dictionary learning, the OMP refit, quantized selection and multiband
dictionary learning."""

from .topk import (
    SparsifyResult,
    sparsify,
    sparsify2,
    sparsify_vectors,
    encourage_sparsity_loss,
    to_key_points,
    ElementwiseSparsity,
    VectorwiseSparsity,
)
from .matching_pursuit import (
    SparseCodeResult,
    sparse_code,
    scatter_events,
    reconstruct_from_events,
    dictionary_learning_step,
    sparse_feature_map,
    sparse_coding_loss,
    flatten_atom_dict,
    SparseCodingLoss,
    AtomPlacement,
)
from .omp_refit import omp_refit, event_tracks
from .quantize import (
    hard_choice,
    select_items,
    set_selection_leak,
    set_selection_floor,
    QuantizedResonanceMixture,
)
from .multiband import BandSpec, MultibandDictionaryLearning
from .fast_mp import sparse_code_fast, dictionary_gram, fast_geometry, encode_state
from .cuda_fused_mp import (
    StepEvents,
    cuda_fused_step,
    cuda_fused_step_pipelined,
    cuda_fused_encode,
    cuda_fused_encode_lane,
    fused_step_plain,
    fused_encode_plain,
    fused_encode_lane_plain,
    fused_step_applicable,
    cluster_size,
    encode_cluster_size,
)
from .cuda_mp import cuda_boundary_update, boundary_update_plain

__all__ = [
    "SparsifyResult",
    "sparsify",
    "sparsify2",
    "sparsify_vectors",
    "encourage_sparsity_loss",
    "to_key_points",
    "ElementwiseSparsity",
    "VectorwiseSparsity",
    "SparseCodeResult",
    "sparse_code",
    "scatter_events",
    "reconstruct_from_events",
    "dictionary_learning_step",
    "sparse_feature_map",
    "sparse_coding_loss",
    "flatten_atom_dict",
    "SparseCodingLoss",
    "AtomPlacement",
    "omp_refit",
    "event_tracks",
    "hard_choice",
    "select_items",
    "set_selection_leak",
    "set_selection_floor",
    "QuantizedResonanceMixture",
    "BandSpec",
    "MultibandDictionaryLearning",
    "sparse_code_fast",
    "dictionary_gram",
    "fast_geometry",
    "encode_state",
    "StepEvents",
    "cuda_fused_step",
    "cuda_fused_step_pipelined",
    "cuda_fused_encode",
    "cuda_fused_encode_lane",
    "fused_step_plain",
    "fused_encode_plain",
    "fused_encode_lane_plain",
    "fused_step_applicable",
    "cluster_size",
    "encode_cluster_size",
    "cuda_boundary_update",
    "boundary_update_plain",
]
