"""Data of the port (counterpart of ``mptpu.data``; only the ported
names): the synthetic corpus, the sqlite KV store, file discovery with
memoised decode, and the batch iterators."""

from .audioiter import AudioIterator, audio_stream, get_one_audio_batch, get_one_audio_segment
from .datastore import (audio, batch_stream, iter_audio_segments, iter_chunks, iter_files,
                        iter_files_in_random_order)
from .kv import KVCollection, cache
from .synthetic import ensure_demo_dataset, streaming_windows, synthetic_audio

__all__ = ["AudioIterator", "audio_stream", "get_one_audio_batch", "get_one_audio_segment",
           "audio", "batch_stream", "iter_audio_segments", "iter_chunks", "iter_files",
           "iter_files_in_random_order", "KVCollection", "cache",
           "ensure_demo_dataset", "streaming_windows", "synthetic_audio"]
