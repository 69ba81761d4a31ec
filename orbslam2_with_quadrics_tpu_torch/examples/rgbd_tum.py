"""RGB-D TUM driver (the original system's Examples/RGB-D/rgbd_tum).

    python -m orbslam2_with_quadrics_tpu_torch.examples.rgbd_tum \
        <settings.yaml> <sequence_dir> <associations.txt> [traj_out] [--device cuda|cpu]

Reads the association file's grey and depth images and writes the
per-frame trajectory in the TUM format. The depth maps go to the card as
their raw uint16 counts; ``DepthMapFactor`` scales them there.
"""

from __future__ import annotations

from ..utils import config, datasets, image_io, metrics, trajectory
from . import common


def main(settings_path, seq_dir, assoc, traj_out="trajectory_tum.txt", device="cuda"):
    decoder = common.announce_decoder()
    settings = config.load_settings(settings_path)
    items = datasets.load_tum_associations(seq_dir, assoc)
    h, w = common.image_size(items[0][1])
    fcfg = config.frontend_config_from_settings(settings, h, w)
    slam = common.make_system(settings, fcfg, "rgbd", common.POOLS_SMALL, device,
                              depth_factor=config.depth_map_factor(settings))
    with image_io.AsyncImageLoader([r for _, r, _ in items], n_threads=1) as grey, \
            image_io.AsyncImageLoader([d for _, _, d in items], n_threads=1) as depth:
        times = common.track_all(slam.track_rgbd, (
            (ts, (img, raw16), {}) for (ts, _, d), (img, _), (_, raw16)
            in zip(items, grey, depth)))
    trajectory.save_tum(traj_out, [(ts, metrics.se3_vec_to_mat(T7))
                                   for _, ts, T7 in slam.full_trajectory()])
    return common.report(slam, times, traj_out, decoder)


if __name__ == "__main__":
    main(**common.parse(__doc__, ("settings_path", "seq_dir", "assoc"),
                        (("traj_out", "trajectory_tum.txt"),)))
