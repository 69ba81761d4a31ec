"""Monocular TUM driver (the original system's Examples/Monocular/mono_tum).

    python -m orbslam2_with_quadrics_tpu_torch.examples.mono_tum \
        <settings.yaml> <sequence_dir> [traj_out] [detections_dir] [--device cuda|cpu]

Reads ``rgb.txt``, tracks every frame and writes the per-frame trajectory
in the TUM format to ``traj_out`` (and ``traj_out.metrics.jsonl``). The
vocabulary is the shipped one. ``detections_dir``: optional per-frame object
detections, ``<image basename>.txt`` with ``x y w h prob class`` rows, which
turn on the dual-quadric landmarks.
"""

from __future__ import annotations

import os

from ..utils import config, datasets, image_io, metrics, trajectory, viz
from . import common


def main(settings_path, seq_dir, traj_out="trajectory_tum.txt", detections_dir=None,
         device="cuda"):
    decoder = common.announce_decoder()
    settings = config.load_settings(settings_path)
    rgb = datasets.load_tum_rgb_list(seq_dir)
    h, w = common.image_size(rgb[0][1])
    fcfg = config.frontend_config_from_settings(settings, h, w)
    slam = common.make_system(settings, fcfg, "mono", common.POOLS_SMALL, device,
                              enable_quadrics=detections_dir is not None)

    def dets_for(img_path):
        if detections_dir is None:
            return None
        base = os.path.splitext(os.path.basename(img_path))[0]
        det_path = os.path.join(detections_dir, base + ".txt")
        return datasets.read_obj_detection_txt(det_path) if os.path.exists(det_path) else None

    with image_io.AsyncImageLoader([p for _, p in rgb], n_threads=2) as loader:
        times = common.track_all(slam.track_monocular, (
            (ts, (img,), {"detections": dets_for(path)})
            for (ts, path), (img, _) in zip(rgb, loader)))
    trajectory.save_tum(traj_out, [(ts, metrics.se3_vec_to_mat(T7))
                                   for _, ts, T7 in slam.full_trajectory()])
    viz.save_metrics_jsonl(traj_out + ".metrics.jsonl", slam.metrics)
    return common.report(slam, times, traj_out, decoder, lines=("kf_points_loops",))


if __name__ == "__main__":
    main(**common.parse(__doc__, ("settings_path", "seq_dir"),
                        (("traj_out", "trajectory_tum.txt"), ("detections_dir", None))))
