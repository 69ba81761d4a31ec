"""Command-line scripts of the port, run as modules:

- ``eval_full``: the dataset-scale synthetic evaluation (1,500 frames);
- ``smoke_mono``, ``smoke_stereo``: short end-to-end drives with a PASS /
  FAIL line.
"""
