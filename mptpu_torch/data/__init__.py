"""Data of the port (counterpart of ``mptpu.data``; only the ported
names): the synthetic corpus and stream, the sqlite KV store, file
discovery with memoised decode, the batch iterators, the URL fetch and
the native C++ loader."""

from .audioiter import AudioIterator, audio_stream, get_one_audio_batch, get_one_audio_segment
from .datastore import (audio, batch_stream, iter_audio_segments, iter_chunks, iter_files,
                        iter_files_in_random_order)
from .kv import KVCollection, cache
from .fetch import default_transport, get_audio_segment
from .native import NativeAudioLoader, build_native, native_available
from .synthetic import ensure_demo_dataset, fresh_segment_stream, streaming_windows, synthetic_audio

__all__ = ["AudioIterator", "audio_stream", "get_one_audio_batch", "get_one_audio_segment",
           "audio", "batch_stream", "iter_audio_segments", "iter_chunks", "iter_files",
           "iter_files_in_random_order", "KVCollection", "cache",
           "default_transport", "get_audio_segment", "NativeAudioLoader", "build_native",
           "native_available", "ensure_demo_dataset", "fresh_segment_stream", "streaming_windows",
           "synthetic_audio"]
