"""Greedy matching pursuit, naive and fast, with its CUDA kernels
(counterpart of ``mptpu.sparse``; only the ported names)."""

from .matching_pursuit import (
    SparseCodeResult,
    sparse_code,
    scatter_events,
    reconstruct_from_events,
    dictionary_learning_step,
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
    "SparseCodeResult",
    "sparse_code",
    "scatter_events",
    "reconstruct_from_events",
    "dictionary_learning_step",
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
