"""Command-line scripts of the port, run as modules:

- ``eval_full``: the dataset-scale synthetic evaluation (1,500 frames);
- ``smoke_mono``, ``smoke_stereo``: short end-to-end drives with a PASS /
  FAIL line;
- the measuring tools, twins of the reference package's ``scripts/``:
  ``debug_oab`` (out-and-back diagnosis), ``bench_ba`` (BA iterations per
  second), ``profile_lba`` (the dense local BA's pieces), ``profile_track``
  and ``bench_profile`` (per-stage frame time; their shared setup and timing
  in ``common``), ``train_vocab`` (the vocabulary asset and its retrieval
  check), ``bench_dist_ba`` (distributed-BA weak scaling).
"""
