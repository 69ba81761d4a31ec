"""Monocular EuRoC driver (the original system's Examples/Monocular/mono_euroc).

    python -m orbslam2_with_quadrics_tpu_torch.examples.mono_euroc \
        <settings.yaml> <mav_sequence_dir> [traj_out] [--device cuda|cpu]

Reads ``mav0/cam0/data.csv`` and writes the per-frame trajectory in the TUM
format (and ``traj_out.metrics.jsonl``).
"""

from __future__ import annotations

from ..utils import config, datasets, image_io, metrics, trajectory, viz
from . import common


def main(settings_path, seq_dir, traj_out="trajectory_tum.txt", device="cuda"):
    decoder = common.announce_decoder()
    settings = config.load_settings(settings_path)
    items = datasets.load_euroc_mono(seq_dir)
    h, w = common.image_size(items[0][1])
    fcfg = config.frontend_config_from_settings(settings, h, w)
    slam = common.make_system(settings, fcfg, "mono", common.POOLS_SMALL, device)
    with image_io.AsyncImageLoader([p for _, p in items], n_threads=2) as loader:
        times = common.track_all(slam.track_monocular, (
            (ts, (img,), {}) for (ts, _), (img, _) in zip(items, loader)))
    trajectory.save_tum(traj_out, [(ts, metrics.se3_vec_to_mat(T7))
                                   for _, ts, T7 in slam.full_trajectory()])
    viz.save_metrics_jsonl(traj_out + ".metrics.jsonl", slam.metrics)
    return common.report(slam, times, traj_out, decoder)


if __name__ == "__main__":
    main(**common.parse(__doc__, ("settings_path", "seq_dir"),
                        (("traj_out", "trajectory_tum.txt"),)))
