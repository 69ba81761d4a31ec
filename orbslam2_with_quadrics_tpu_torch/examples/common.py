"""What the six drivers share: the command line, the System built from a
settings file, the timed frame loop and the closing report."""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..models import map_state as ms
from ..models import system as sysm
from ..utils import config, image_io

# map pools of the reference drivers: TUM and EuRoC mono, KITTI and EuRoC stereo
POOLS_SMALL = (512, 65536)
POOLS_LARGE = (1024, 131072)


def parse(doc: str, required, optional=(), argv=None) -> dict:
    """``main``'s keyword arguments from the command line: the positional
    arguments ``required`` (names) and ``optional`` ((name, default)
    pairs), and ``--device``."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0], epilog=doc,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    for name in required:
        ap.add_argument(name)
    for name, default in optional:
        ap.add_argument(name, nargs="?", default=default)
    ap.add_argument("--device", default="cuda",
                    help="where the map and every tensor live (default: cuda)")
    return vars(ap.parse_args(argv))


def announce_decoder() -> str:
    """Print this process's image decoder (and why an earlier one was
    passed over); raise if there is none."""
    d = image_io.decoder()
    print(f"image decoder: {d.name}" + (f" ({d.why})" if d.why else ""), flush=True)
    return d.name


def image_size(path: str):
    """(height, width) of an image on disk."""
    return image_io.load_gray(path).shape


def make_system(settings: dict, fcfg, sensor: str, pools, device: str, **kw) -> sysm.System:
    """The System a reference driver builds: its sensor and pools, loop
    closing on, the forced keyframe cadence of the camera's frame rate."""
    max_kf, max_pt = pools
    cfg = sysm.SystemConfig(
        frontend=fcfg,
        map=ms.MapConfig(max_keyframes=max_kf, max_points=max_pt, n_features=fcfg.n_features,
                         n_levels=fcfg.n_levels, device=device),
        sensor=sensor,
        max_frames_between_kf=int(config.camera_fps(settings)),
        enable_loop_closing=True,
        **kw,
    )
    return sysm.System(cfg)


def track_all(step, frames) -> list:
    """``step(*args, timestamp=ts, **kw)`` for each (ts, args, kw) of
    ``frames``; returns the seconds of each call, on the host's clock, as
    the reference drivers time them (the card's work may still run)."""
    times = []
    for ts, args, kw in frames:
        t0 = time.perf_counter()
        step(*args, timestamp=float(ts), **kw)
        times.append(time.perf_counter() - t0)
    return times


def report(slam, times, traj_out: str, decoder: str, lines=("times",)) -> dict:
    """Print the reference driver's closing lines (``lines`` of "times",
    "kf_points_loops", "kf_loops"); return the run's numbers."""
    t = np.asarray(times)
    n_kf, n_pt = int(slam.map.n_kf), int(slam.map.n_pt)
    print(f"median tracking time: {np.median(t):.4f}")
    print(f"mean tracking time: {t.mean():.4f}")
    if "kf_points_loops" in lines:
        print(f"keyframes: {n_kf} points: {n_pt} loops: {slam.n_loops_closed}")
    if "kf_loops" in lines:
        print(f"keyframes: {n_kf} loops: {slam.n_loops_closed}")
    print(f"trajectory saved to {traj_out}", flush=True)
    return {"times": times, "n_kf": n_kf, "n_pt": n_pt, "kfs_created": slam.n_kfs_created,
            "n_loops_closed": slam.n_loops_closed, "traj_out": traj_out, "decoder": decoder,
            "system": slam}
