"""Offline vocabulary training: a >= 10^5-word BoW tree for this project's
BRIEF pattern, and its retrieval check.

    python -m orbslam2_with_quadrics_tpu_torch.scripts.train_vocab [--frames 240] [--features 2000]
        [--k 10] [--levels 5] [--out PATH] [--device cuda|cpu]

Descriptors are extracted (``frontend.extract_mono``) from a synthetic
corpus of many textures and motions, exact duplicates removed, and a
hierarchical Hamming k-medians tree is trained on them (``vocab.train``),
saved with ``vocab.save``, and checked on a held-out revisit sequence: the
last frame of an orbit that returns to its start must score the start's
frames highest (``validate_retrieval``). One JSON report line.

The counterpart of the reference's ``scripts/train_vocab.py``: the same
corpus (texture seeds, motions, plane sizes), the same descriptors (but
for the rare BRIEF bit that the two frameworks' rounding flips), the same
report keys. Its k-medians seeds come from a
``torch.Generator`` instead of a ``jax.random`` key, so the tree is not the
reference's bit for bit; it is held by its retrieval result. ``--out``
defaults under ``build/``: the script never writes the shipped
``assets/vocab_100k.npz`` or ``VOCAB_TRAIN.json``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time

import numpy as np
import torch

from ..models import frontend as fe
from ..ops import vocab as vocab_mod
from ..utils import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def collect_descriptors(n_frames: int, n_features: int, h: int, w: int, device="cuda"):
    """[D, 8] uint32 unique descriptors of the training corpus: 12 frames of
    each of ``n_frames // 12`` textures, cycling strafe / orbit_loop /
    survey over planes of half-size 3-7, relief on every other texture."""
    fx = 520.0 * w / 640.0
    cfg = fe.FrontendConfig(height=h, width=w, n_features=n_features, n_levels=8,
                            fx=fx, fy=fx, cx=w / 2.0, cy=h / 2.0)
    out = []
    t0 = time.time()
    done = 0
    for tex_seed in range(max(n_frames // 12, 1)):
        for img, _ in synthetic.planar_stream(
            n_frames=12, h=h, w=w, fx=fx, fy=fx, seed=100 + tex_seed,
            motion=("strafe", "orbit_loop", "survey")[tex_seed % 3],
            plane_half=3.0 + (tex_seed % 5), relief=(tex_seed % 2 == 0),
        ):
            feats = fe.extract_mono(cfg, torch.as_tensor(img, device=device))
            out.append(feats.desc[feats.valid].cpu().numpy().view(np.uint32))
            done += 1
            if done % 24 == 0:
                print(f"extracted {done} frames, {sum(len(o) for o in out)} descriptors, "
                      f"t={time.time() - t0:.0f}s", flush=True)
    # exact duplicates (textures repeat under the wrapped border), rows
    # sorted as unsigned words like the reference's
    return np.unique(np.concatenate(out, axis=0), axis=0)


def l1_score(wa, wb, idf) -> float:
    """DBoW2's L1 similarity of two frames' word ids over tf-idf bags, in
    plain Python."""
    def bag(ws):
        c = collections.Counter(int(x) for x in ws if x >= 0)
        tot = sum(c.values())
        return {k: v / tot * idf[k] for k, v in c.items()} if tot else {}

    A, B = bag(wa), bag(wb)
    na = sum(abs(v) for v in A.values()) or 1.0
    nb = sum(abs(v) for v in B.values()) or 1.0
    s = 0.0
    for k, va in A.items():
        if k in B:
            va_, vb_ = va / na, B[k] / nb
            s += abs(va_) + abs(vb_) - abs(va_ - vb_)
    return 0.5 * s


def validate_retrieval(voc, h=240, w=320, n_features=512, device="cuda") -> dict:
    """Hold-out check: over a 40-frame ``orbit_loop`` (seed 999) that
    returns to its start, the last frame is scored against frames 0-31;
    the revisited place is frames 0-3."""
    fx = 260.0 * w / 320.0
    cfg = fe.FrontendConfig(height=h, width=w, n_features=n_features, n_levels=4,
                            fx=fx, fy=fx, cx=w / 2.0, cy=h / 2.0)
    n = 40
    words_all = []
    for img, _ in synthetic.planar_stream(n_frames=n, h=h, w=w, fx=fx, fy=fx, seed=999,
                                          motion="orbit_loop", plane_half=4.0, relief=True):
        feats = fe.extract_mono(cfg, torch.as_tensor(img, device=device))
        wid, _ = vocab_mod.transform_any(voc, feats.desc, feats.valid)
        words_all.append(wid.cpu().numpy())
    idf = voc.idf.cpu().numpy()
    q = words_all[-1]
    scores = [l1_score(q, words_all[i], idf) for i in range(n - 8)]
    truth = int(np.argmax(scores))
    top5 = np.argsort(scores)[::-1][:5]
    return {
        "revisit_top1_hit": bool(truth <= 3),
        "revisit_top5_hit": bool(any(t <= 3 for t in top5)),
        "best_match_frame": truth,
        "score_best": float(max(scores)),
        "score_median": float(np.median(scores)),
        "separation": float(max(scores) / max(np.median(scores), 1e-9)),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--features", type=int, default=2000)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help="the .npz to write (default: build/vocab/vocab_<words>k.npz)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    words = args.k ** args.levels
    out = args.out or os.path.join(REPO, "build", "vocab", f"vocab_{words // 1000}k.npz")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    dev = args.device
    cuda = torch.device(dev).type == "cuda"

    print(f"collecting descriptors ({args.frames} frames x {args.features} features)...",
          flush=True)
    t0 = time.time()
    with torch.no_grad():
        desc = collect_descriptors(args.frames, args.features, args.height, args.width, dev)
    t_collect = time.time() - t0
    print(f"training on {len(desc)} unique descriptors -> {args.k}^{args.levels} = {words} "
          f"words", flush=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
    t0 = time.time()
    with torch.no_grad():
        voc = vocab_mod.train(torch.as_tensor(desc.view(np.int32), device=dev), k=args.k,
                              levels=args.levels, seed=0)
    if cuda:
        torch.cuda.synchronize()
    t_train = time.time() - t0
    vocab_mod.save(out, voc)
    sz = os.path.getsize(out) / 1e6
    print(f"trained in {t_train:.3f}s, saved {out} ({sz:.1f} MB)", flush=True)

    print("validating retrieval on held-out revisit sequence...", flush=True)
    with torch.no_grad():
        val = validate_retrieval(voc, device=dev)
    report = {
        "asset": os.path.relpath(os.path.abspath(out), REPO),
        "words": words, "k": args.k, "levels": args.levels,
        "train_descriptors": int(len(desc)),
        "train_seconds": round(t_train, 3),
        "asset_mb": round(sz, 2),
        "retrieval": val,
        "collect_seconds": round(t_collect, 3),
        "peak_gib": (torch.cuda.max_memory_allocated() / 2**30) if cuda else None,
    }
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
