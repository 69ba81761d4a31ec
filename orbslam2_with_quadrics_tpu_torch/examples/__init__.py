"""The example drivers: a dataset directory on disk in, a trajectory file
out, one ``System.track_*`` call per frame.

Counterparts of the reference package's ``examples/*.py`` (the original
system's ``Examples/``), with the same positional arguments, map pools and
printed lines, plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch path). Run one as a module:

    python -m orbslam2_with_quadrics_tpu_torch.examples.mono_tum \\
        <settings.yaml> <sequence_dir> [traj_out] [detections_dir] [--device cpu]

``mono_tum``, ``rgbd_tum``, ``stereo_kitti``, ``mono_kitti``, ``mono_euroc``
and ``stereo_euroc``. Each prints the image decoder it uses (see
``utils/image_io``).
"""
