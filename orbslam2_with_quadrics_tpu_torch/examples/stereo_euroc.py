"""Stereo EuRoC driver (the original system's Examples/Stereo/stereo_euroc).

    python -m orbslam2_with_quadrics_tpu_torch.examples.stereo_euroc \
        <settings.yaml> <mav_sequence_dir> [traj_out] [vocab] [--device cuda|cpu]

EuRoC's images are not rectified. As the original system does, each pair
is rectified on the host with the settings' LEFT.* / RIGHT.* blocks
(``config.euroc_rectify_maps`` and ``config.remap_bilinear``, OpenCV's
arithmetic in numpy) and the rectified pair is tracked. Writes the
per-frame trajectory in the TUM format.
"""

from __future__ import annotations

import dataclasses

from ..utils import config, datasets, image_io
from . import common


def main(settings_path, seq_dir, traj_out="trajectory_euroc.txt", vocab=None, device="cuda"):
    decoder = common.announce_decoder()
    settings = config.load_settings(settings_path)
    maps = config.euroc_rectify_maps(settings)
    if maps is None:
        raise SystemExit("the settings file carries no LEFT.* / RIGHT.* rectification blocks")
    (mxl, myl), (mxr, myr) = maps
    times_arr, lefts, rights = datasets.load_euroc_stereo(seq_dir)
    h, w = int(settings["LEFT.height"]), int(settings["LEFT.width"])
    # the remap removes the distortion
    fcfg = dataclasses.replace(config.frontend_config_from_settings(settings, h, w),
                               k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
    slam = common.make_system(settings, fcfg, "stereo", common.POOLS_LARGE, device,
                              vocab_path=vocab)
    with image_io.AsyncImageLoader(lefts, n_threads=1) as left, \
            image_io.AsyncImageLoader(rights, n_threads=1) as right:
        times = common.track_all(slam.track_stereo, (
            (ts, (config.remap_bilinear(il, mxl, myl), config.remap_bilinear(ir, mxr, myr)), {})
            for ts, (il, _), (ir, _) in zip(times_arr, left, right)))
    slam.shutdown()
    slam.save_trajectory_tum(traj_out)
    return common.report(slam, times, traj_out, decoder, lines=("kf_loops",))


if __name__ == "__main__":
    main(**common.parse(__doc__, ("settings_path", "seq_dir"),
                        (("traj_out", "trajectory_euroc.txt"), ("vocab", None))))
