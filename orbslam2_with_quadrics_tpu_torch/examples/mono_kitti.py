"""Monocular KITTI driver (the original system's Examples/Monocular/mono_kitti).

    python -m orbslam2_with_quadrics_tpu_torch.examples.mono_kitti \
        <settings.yaml> <sequence_dir> [traj_out] [vocab] [--device cuda|cpu]

Reads ``image_0/`` and ``times.txt`` and writes the keyframe trajectory in
the TUM format (a monocular map has no metric scale, so the KITTI file is
left to the stereo driver, as in the original system). ``vocab``: a
vocabulary file (DBoW2 ``.txt`` or this package's ``.npz``); without one
the vocabulary is trained from the sequence's first keyframes.
"""

from __future__ import annotations

from ..utils import config, datasets, image_io
from . import common


def main(settings_path, seq_dir, traj_out="keyframes_mono_kitti.txt", vocab=None,
         device="cuda"):
    decoder = common.announce_decoder()
    settings = config.load_settings(settings_path)
    times_arr, paths = datasets.load_kitti_mono(seq_dir)
    h, w = common.image_size(paths[0])
    fcfg = config.frontend_config_from_settings(settings, h, w)
    slam = common.make_system(settings, fcfg, "mono", common.POOLS_LARGE, device,
                              vocab_path=vocab)
    with image_io.AsyncImageLoader(paths, n_threads=2) as loader:
        times = common.track_all(slam.track_monocular, (
            (ts, (img,), {}) for ts, (img, _) in zip(times_arr, loader)))
    slam.shutdown()
    slam.save_keyframe_trajectory_tum(traj_out)
    return common.report(slam, times, traj_out, decoder, lines=("kf_loops",))


if __name__ == "__main__":
    main(**common.parse(__doc__, ("settings_path", "seq_dir"),
                        (("traj_out", "keyframes_mono_kitti.txt"), ("vocab", None))))
