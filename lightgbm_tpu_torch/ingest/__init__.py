"""Streamed text ingest and the bins' chunked copy to the device.

PyTorch-port counterpart of ``lightgbm_tpu/ingest/`` (ROADMAP Queue A item
10b):

- ``chunker.py``: bounded, resumable chunks of a text file through the
  native field parser (the monolithic load's values, bit for bit);
- ``pipeline.py``: the two-pass build (pass 1 the monolithic sample rows,
  pass 2 parse, bin and pack per chunk, into memory or a cache artifact);
- ``prefetch.py``: the double-buffered chunked copy of a dataset's bins
  to the device.

The ``LGBMTPU2`` cache itself (``ingest/cache.py`` in the JAX package) is
``io/cache.py`` here. A model trained from the streamed or cached path is
byte-equal to one trained from the monolithic load.
"""
from .pipeline import ingest_text_streamed, streaming_eligible
from .prefetch import IngestStats, stream_to_device

__all__ = ["ingest_text_streamed", "streaming_eligible", "IngestStats",
           "stream_to_device"]
