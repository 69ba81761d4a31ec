"""Stereo KITTI driver (the original system's Examples/Stereo/stereo_kitti).

    python -m orbslam2_with_quadrics_tpu_torch.examples.stereo_kitti \
        <settings.yaml> <sequence_dir> [traj_out] [--device cuda|cpu]

Reads ``image_0/``, ``image_1/`` and ``times.txt`` and writes the per-frame
trajectory in the KITTI format (3x4 T_wc rows) for the odometry devkit.
"""

from __future__ import annotations

from ..utils import config, datasets, image_io, metrics, trajectory
from . import common


def main(settings_path, seq_dir, traj_out="trajectory_kitti.txt", device="cuda"):
    decoder = common.announce_decoder()
    settings = config.load_settings(settings_path)
    times_arr, lefts, rights = datasets.load_kitti_stereo(seq_dir)
    h, w = common.image_size(lefts[0])
    fcfg = config.frontend_config_from_settings(settings, h, w)
    slam = common.make_system(settings, fcfg, "stereo", common.POOLS_LARGE, device)
    with image_io.AsyncImageLoader(lefts, n_threads=1) as left, \
            image_io.AsyncImageLoader(rights, n_threads=1) as right:
        times = common.track_all(slam.track_stereo, (
            (ts, (il, ir), {}) for ts, (il, _), (ir, _) in zip(times_arr, left, right)))
    trajectory.save_kitti(traj_out, [(ts, metrics.se3_vec_to_mat(T7))
                                     for _, ts, T7 in slam.full_trajectory()])
    return common.report(slam, times, traj_out, decoder, lines=("kf_loops",))


if __name__ == "__main__":
    main(**common.parse(__doc__, ("settings_path", "seq_dir"),
                        (("traj_out", "trajectory_kitti.txt"),)))
