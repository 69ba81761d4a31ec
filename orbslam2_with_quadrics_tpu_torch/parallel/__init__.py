"""Distributed bundle adjustment and sharded retrieval over
``torch.distributed`` (``dist_ba``), the spawn helper (``launch``), the
synthetic problems of the two command-line checks (``problems``), and the
checks themselves (``python -m orbslam2_with_quadrics_tpu_torch.parallel.dryrun``
and ``... .parallel.multihost``)."""
