"""Radar filter CLI — standalone filter stage (the `radar_filter_node`
equivalent, `src/radar_filter_node.cpp` + `radar_driver.cpp`).

Port of the reference's `radar_filter.py`. Reads sweeps (synthetic or a
dataset directory), runs k-strongest/CA-CFAR filtering on the CUDA card
(`--cpu`: on the CPU), and writes the filtered + peaks point clouds per
frame to an npz, optionally rendering a debug plot of the first frame.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="synthetic",
                    choices=["synthetic", "oxford", "mulran"])
    ap.add_argument("--radar-dir", default=None)
    ap.add_argument("--n-frames", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--output", default="/tmp/filtered.npz")
    ap.add_argument("--plot", default=None)
    ap.add_argument("--filter_type", default="kstrong",
                    choices=["kstrong", "cacfar"])
    ap.add_argument("--k_strongest", type=int, default=None)
    ap.add_argument("--z_min", type=int, default=None)
    ap.add_argument("--cfar_window", type=int, default=None)
    ap.add_argument("--cfar_guard", type=int, default=None)
    ap.add_argument("--false_alarm_rate", type=float, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="filter on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)

    import dataclasses

    import torch

    from cfear_radarodometry_code_public_tpu_torch.models.odometry import (
        resolve_device)

    from cfear_radarodometry_code_public_tpu_torch.config import preset
    from cfear_radarodometry_code_public_tpu_torch.datasets import oxford, synthetic
    from cfear_radarodometry_code_public_tpu_torch.ops import filtering

    cfg = preset("CFEAR-3", dataset=args.dataset)
    over = {k: v for k, v in dict(method=args.filter_type,
                                  k_strongest=args.k_strongest,
                                  z_min=args.z_min,
                                  cfar_window=args.cfar_window,
                                  cfar_guard=args.cfar_guard,
                                  false_alarm_rate=args.false_alarm_rate
                                  ).items() if v is not None}
    cfg = cfg.replace(filter=dataclasses.replace(cfg.filter, **over))

    if args.dataset == "synthetic":
        images, _ = synthetic.make_sequence(args.seed, args.n_frames, cfg)
        stamps = np.arange(len(images)) * cfg.radar.sensor_period
    else:
        src = (oxford.oxford_frames(args.radar_dir) if args.dataset == "oxford"
               else oxford.mulran_frames(args.radar_dir))
        stamps, images = [], []
        for i, (t, img) in enumerate(src):
            if i >= args.n_frames:
                break
            stamps.append(t)
            images.append(img)
        images, stamps = np.stack(images), np.asarray(stamps)

    device = resolve_device("cpu" if args.cpu else "cuda", "radar_filter")
    out = {"stamps": stamps}
    for i, img in enumerate(images):
        pc = filtering.filter_polar_image(torch.as_tensor(img).to(device), cfg)
        pc = filtering.PointCloud(*(a.cpu().numpy() for a in pc))
        out[f"xy_{i}"] = pc.xy[pc.valid]
        out[f"intensity_{i}"] = pc.intensity[pc.valid]
        out[f"peaks_{i}"] = pc.peak[pc.valid]
    np.savez_compressed(args.output, **out)
    n0 = len(out["xy_0"])
    print(f"filtered {len(images)} frames -> {args.output} "
          f"(frame 0: {n0} points, {int(out['peaks_0'].sum())} peaks)")

    if args.plot:
        from cfear_radarodometry_code_public_tpu_torch.eval import viz
        viz.plot_scan(args.plot, images[0], out["xy_0"])
        print(f"plot -> {args.plot}")


if __name__ == "__main__":
    main()
