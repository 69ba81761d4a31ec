"""Stereo left-right keypoint matching with subpixel refinement.

Counterpart of the reference's ``ops/stereo.py`` (ComputeStereoMatches):
one masked [N_l, N_r] Hamming best match (row band +-2 px scaled by the
octave, a one-sided disparity range, octaves within one of each other),
then an 11x11 SAD search over +-5 px shifts at level 0, centre-normalised,
and a parabola fit for the subpixel disparity.

The coarse match is plain PyTorch (``matching.hamming_matrix`` +
``best_two``), as it is plain jnp in the reference: its mask is a row band
with a one-sided disparity range, not the square window of
``cuda_kernels.masked_hamming_best2``.
"""

from __future__ import annotations

import torch

from . import matching

_W = 5  # SAD half window: 11x11 patches, 11 shifts


def stereo_match(cfg, img_l, img_r, fl, fr):
    """Returns (ur [N], depth [N]) for the left keypoints; -1 / 0 where
    there is no match.

    cfg: FrontendConfig-like (bf, fx, scale_factor, n_levels). img_l, img_r:
    [H,W] float32. fl: left FrameFeatures (or orb.Features with uv / level /
    desc / valid); fr: right orb.Features.
    """
    dev = fl.uv.device
    H, Wd = img_l.shape
    sf = torch.tensor([cfg.scale_factor ** i for i in range(cfg.n_levels)],
                      dtype=torch.float32, device=dev)

    # row band: |v_l - v_r| <= 2 * scale(octave_l)
    lvl_l = fl.level.to(torch.int64)
    band = 2.0 * sf[torch.clamp(lvl_l, 0, cfg.n_levels - 1)]
    dv = torch.abs(fl.uv[:, 1:2] - fr.uv[None, :, 1])
    # disparity in [-3, bf / baseline] = [-3, fx]
    disp = fl.uv[:, 0:1] - fr.uv[None, :, 0]
    mask = (
        fl.valid[:, None] & fr.valid[None, :]
        & (dv <= band[:, None])
        & (disp >= -3.0) & (disp <= cfg.fx)
        & (torch.abs(lvl_l[:, None] - fr.level.to(torch.int64)[None, :]) <= 1)
    )
    best_idx, best, _ = matching.best_two(matching.hamming_matrix(fl.desc, fr.desc), mask)
    ok = best <= matching.TH_HIGH

    # --- SAD subpixel refinement around the matched column (level 0) ---
    w = _W
    ur_coarse = fr.uv[best_idx, 0]

    def px(x, lo, hi):  # round half to even, as the reference's jnp.round
        return torch.clamp(torch.round(x).to(torch.int64), lo, hi)

    ys = px(fl.uv[:, 1], w, H - w - 1)
    xl = px(fl.uv[:, 0], w, Wd - w - 1)
    xr0 = px(ur_coarse, w + 5, Wd - w - 6)
    d = torch.arange(-w, w + 1, device=dev)
    dyy = d.repeat_interleave(2 * w + 1)        # row-major 11x11 offsets
    dxx = d.repeat(2 * w + 1)
    centre = (2 * w + 1) * w + w
    rows = ys[:, None] + dyy[None, :]                           # [N,121]

    patch_l = img_l[rows, xl[:, None] + dxx[None, :]]
    patch_l = patch_l - patch_l[:, centre:centre + 1]
    # the 11 shifted right patches at once: [11,N,121]
    cols = (xr0[None, :] + d[:, None])[:, :, None] + dxx[None, None, :]
    pr = img_r[rows[None], cols]
    pr = pr - pr[:, :, centre:centre + 1]
    sads = torch.sum(torch.abs(patch_l[None] - pr), dim=2)      # [11,N]
    bi = torch.argmin(sads, dim=0)                              # first minimum
    # parabola through (bi-1, bi, bi+1)
    bi_c = torch.clamp(bi, 1, 9)
    s0 = torch.gather(sads, 0, (bi_c - 1)[None])[0]
    s1 = torch.gather(sads, 0, bi_c[None])[0]
    s2 = torch.gather(sads, 0, (bi_c + 1)[None])[0]
    denom = torch.clamp(s0 + s2 - 2.0 * s1, min=1e-6)
    delta = torch.clamp(0.5 * (s0 - s2) / denom, -1.0, 1.0)

    ur = ur_coarse + (bi_c - w).to(torch.float32) + delta
    disparity = fl.uv[:, 0] - ur
    ok = ok & (disparity > 0.01) & (disparity < cfg.fx)
    depth = torch.where(ok, cfg.bf / torch.clamp(disparity, min=1e-6), 0.0)
    return torch.where(ok, ur, -1.0), depth
