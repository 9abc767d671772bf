#!/usr/bin/env python3
"""Time the motion search's kernels, the inter coder, the loop filter and
the probe's coder of one checkout of av1tpu_torch on a GPU.

    python3 tools/search_compare.py [--inputs FILE] [--coder FILE ...]
                                    [--deblock FILE] [--probe FILE]
                                    [--chain FILE] [--cdef FILE]
                                    [--root DIR]
    python3 tools/search_compare.py --coder FILE --make-coder DIR

Imports av1tpu_torch from DIR (default: this checkout) and builds its CUDA
kernels (printing the -Xptxas -v lines of motion.cu, inter_code.cu,
deblock.cu, cdef.cu and intra_part.cu's part_code and part_chain).

--inputs: times coarse_search, global_search and refine_subpel on the pair
that chip_smoke.py's phase 7d saved to FILE (its first 1080p inter frame,
the keyframe's recon, the frame's lambda and peak value), with phase 7d's
own timing (chip_smoke.search_times), and coarse_search's launches one by
one (chip_smoke.kernel_us_by_name, torch.profiler).  Prints one JSON line
per wrapper: its device time per call, its launches per call and the
bound of this checkout's chip_smoke.search_bounds.

--coder (repeatable): times code_blocks on each FILE's batches (the 8
that phase 7c saved from its first 1080p inter frame, or those of
--make-coder), with phase 7c's own timing (chip_smoke.coder_times).
Prints one JSON line per batch (device us per launch, chip_smoke.
code_bounds, the blocks without a level, whose inverse the kernel skips)
and one per file for the frame.

--deblock: times deblock_edges on the planes that phase 7d saved to FILE
(its quality inter frame's recon, edge maps, levels and split map), with
phase 7d's own timing (chip_smoke.deblock_times): one JSON line per
launch (per plane; per plane and direction for an older checkout whose
kernel filters one direction a launch) and one for the frame.

--probe: times part_code, part_pred and part_merge on the probed frame
that phase 7e saved to FILE (its planes, q and bit depth): the probe runs
once with part_code's calls caught (chip_smoke.capture_code_calls), then
each launch kind is timed with phase 7e's own timing (chip_smoke.
code_kinds).  One JSON line per kind (device us per launch and per frame,
launches, columns, CTAs with work, each site alone, the columns without a
level per site) and one for the frame.  Then the probe runs once more
caught as its device sequence (chip_smoke.capture_probe_sequence):
part_pred's and part_merge's launch kinds, each kind's calls back to back
(chip_smoke.pred_merge_kinds: us a launch and per frame, CTAs; a launch
may start during the previous one's tail), one JSON line per kind and one
per kernel for the frame; and the whole sequence (chain, preds, cuBLAS
products, codes, merges) replayed, its luma and its chroma part each
with events around it only, summed, five times (chip_smoke.sequence_us),
with the sha256 of every output grid and
of each luma merge's region costs, which two checkouts whose kernels
agree bit for bit print alike, and the empty-launch floor
(chip_smoke.empty_launch_us) where the checkout's library has it.

--chain: times part_chain on the probed frame that --probe reads (FILE
is phase 7e's probe_inputs.pt) and on the 10-bit frame phase 7e makes
from it (the planes times 4 plus 2, q 72): the probe runs once with
part_chain's call caught (chip_smoke.capture_chain_jobs), then
chip_smoke.chain_times times the launch of the three planes and each
plane alone.  One JSON line per frame: device us, the serial floor
(chip_smoke.chain_floor_us) and the sha256 of each plane's levels and
recon, which two checkouts whose kernels agree print alike.

--cdef: times cdef_filter on the CDEF input that phase 7c saved to FILE
(cdef_inputs.pt: its first inter frame's planes, skip map and preset)
and on that frame with no unit skipped at the strongest preset, at 8 and
10 bits (chip_smoke.cdef_cases); or, where FILE is phase 7's
cdef_path_inputs.pt (every cdef_filter launch of its quality encode: the
keyframe's, then the inter frames'), on each launch's own input
(chip_smoke.cdef_path_cases), with one more JSON line per part
(chip_smoke.cdef_path_summary).  Phase 7c's own timing
(chip_smoke.cdef_times).  One JSON line per case: device us, the share
of live units, the bounds (chip_smoke.cdef_bounds: bytes and int32
operations) and the sha256 of the three output planes.

--make-coder DIR writes, with this checkout, coder batches in which most
or all blocks carry levels, and times nothing: dense8.pt, FILE's batches
with their source and prediction replaced by random pixels at the full
amplitude (1 << bit depth) - 1 (the card test's _coder_case), the
coefficients their forward product; frame10.pt, the 8 batches of a 1080p
10-bit inter frame at qindex 40 (models/inter_v.encode_inter_part on the
smoke's synthetic clip at 10 bits); dense10.pt, frame10.pt's at full amplitude.

Both of phase 7d's and 7c's files are written where $AV1TPU_SMOKE_OUT is
set.  Whether the outputs equal the plain versions' is the smoke's check,
not this script's.  To compare two commits on one card, unpack the older
one with `git archive` into a directory that .gitignore lists and run
this script on each, in turns, within one command, after the smoke.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dense_batches(torch, sites, seed: int = 0) -> list:
    """sites (coefs, src, pred, plane) with each batch's source and
    prediction replaced by random pixels, the prediction the source plus
    up to the peak value either way and clipped, and the coefficients
    their forward product, as the coder's caller computes it."""
    from av1tpu_torch.state import tables

    out = []
    for k, (coefs, src, pred, plane) in enumerate(sites):
        b, n, dev = src.shape[0], plane.n, src.device
        pm = (1 << plane.bit_depth) - 1
        rng = np.random.RandomState(seed + k)
        s = rng.randint(0, pm + 1, (b, n, n))
        p = np.clip(s + rng.randint(-pm, pm + 1, (b, n, n)), 0, pm)
        s, p = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in (s, p))
        T = tables(dev)
        fwdt = T.fwd64t() if n == 64 else T.fwdt(n, 0)
        c = (s - p).reshape(b, -1).to(torch.float32) @ fwdt
        out.append((c.contiguous(), s, p, plane))
    return out


def frame_batches(torch, dev, bit_depth: int = 10, qindex: int = 40,
                  h: int = 1088, w: int = 1920) -> list:
    """The coder batches (coefs, src, pred, plane) of one h x w inter
    frame at bit_depth and qindex: frame 1 of the smoke's synthetic clip
    (seed 11) at that depth, coded against its frame 0 through
    models/inter_v.encode_inter_part with its code_blocks caught."""
    from av1tpu_torch.models import inter_v
    from av1tpu_torch.utils.yuv import synthetic_clip

    clip = synthetic_clip(w, h, 2, bit_depth=bit_depth, seed=11)

    def planes(k):
        return [torch.from_numpy(a[k].astype(np.int32)).to(dev)
                for a in (clip.y, clip.u, clip.v)]

    sites = []
    coder = inter_v.code_blocks

    def catch(coefs, src, pred, plane):
        sites.append((coefs, src, pred, plane))
        return coder(coefs, src, pred, plane)

    inter_v.code_blocks = catch
    try:
        inter_v.encode_inter_part(*planes(1), *planes(0), qindex,
                                  bit_depth=bit_depth)
    finally:
        inter_v.code_blocks = coder
    return sites


@contextlib.contextmanager
def forward_matrices(probe_file: str):
    """Within the block the probe adopts the forward matrices kept beside
    probe_file (probe_inputs_forward.npz, which the smoke writes too), and
    writes them there after it where they are missing: each run builds
    them otherwise (tens of seconds of np.linalg.pinv).  They are the same
    in every checkout."""
    from av1tpu_torch.ops import transforms

    fwd = os.path.splitext(probe_file)[0] + "_forward.npz"
    if os.path.exists(fwd):
        with np.load(fwd) as z:
            transforms.adopt_forward_matrices(
                {("fwd64" if k == "fwd64" else tuple(
                    int(x) for x in k.split("_"))): z[k] for k in z})
    yield
    if not os.path.exists(fwd):
        np.savez(fwd, **{"_".join(map(str, k)) if k != "fwd64" else k: m
                         for k, m in
                         transforms.built_forward_matrices().items()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--inputs", help="phase 7d's saved pair (chip_smoke.py)")
    ap.add_argument("--coder", action="append", default=[],
                    help="coder batches: phase 7c's or --make-coder's")
    ap.add_argument("--deblock", help="phase 7d's saved planes")
    ap.add_argument("--probe", help="phase 7e's saved probed frame")
    ap.add_argument("--chain", help="phase 7e's saved probed frame")
    ap.add_argument("--cdef", help="phase 7c's saved CDEF input")
    ap.add_argument("--make-coder", metavar="DIR",
                    help="write dense8.pt, frame10.pt and dense10.pt there")
    ap.add_argument("--root", default=HERE,
                    help="checkout whose av1tpu_torch is timed")
    args = ap.parse_args()
    if not (args.inputs or args.coder or args.deblock or args.probe
            or args.chain or args.cdef):
        ap.error("give --inputs, --coder, --deblock, --probe, --chain or "
                 "--cdef")
    if args.make_coder and len(args.coder) != 1:
        ap.error("--make-coder takes one --coder FILE (phase 7c's)")
    sys.path.insert(0, HERE)
    import chip_smoke
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("search_compare: CUDA is not available", file=sys.stderr)
        return 1
    from av1tpu_torch import _build
    from av1tpu_torch.kernels import (
        cdef, deblock, inter_code, intra_part, motion,
    )

    dev = torch.device("cuda")
    if args.make_coder:
        os.makedirs(args.make_coder, exist_ok=True)
        phase7c = chip_smoke.load_coder_inputs(torch, inter_code,
                                               args.coder[0], dev)
        frame10 = frame_batches(torch, dev)
        for name, sites in (("dense8", dense_batches(torch, phase7c)),
                            ("frame10", frame10),
                            ("dense10", dense_batches(torch, frame10))):
            chip_smoke.save_coder_inputs(
                torch, sites, os.path.join(args.make_coder, name + ".pt"))
        return 0
    log = _build.build_cuda()[1]
    print("\n".join(ln for ln in log.splitlines()
                    if "motion" in ln or "inter_code" in ln
                    or "spill" in ln) or log.strip(), flush=True)
    for line in chip_smoke.ptxas_report(log, (
            "deblock_kernel", "part_code", "part_chain", "part_pred",
            "part_merge", "cdef_kernel")):
        print(f"-Xptxas -v {line}", flush=True)
    card = chip_smoke.card_name()
    if args.inputs:
        d = torch.load(args.inputs)
        y, ref_y, lam = d["y"].cuda(), d["ref_y"].cuda(), np.float32(d["lam"])
        pm = int(d["pm"])
        h, w = y.shape
        bounds = chip_smoke.search_bounds(h, w)
        times = chip_smoke.search_times(torch, motion, y, ref_y, lam, pm,
                                        plain=False)
        for name, (dev_us, _, n) in times.items():
            bound, by, bytes_us, ops_us = bounds[name]
            print(json.dumps({
                "root": args.root, "kernel": name, "shape": [h, w],
                "device_us": dev_us, "launches": n, "bound_us": bound,
                "bound_by": by, "bytes_us": bytes_us, "ops_us": ops_us,
                "bound_share": bound / dev_us, "card": card}), flush=True)
        launch_us = chip_smoke.kernel_us_by_name(
            torch, lambda: motion.coarse_search(y, ref_y, lam))
        print(json.dumps({
            "root": args.root, "kernel": "coarse_search", "shape": [h, w],
            "launch_us": {chip_smoke._short(k): v
                          for k, v in launch_us.items()}, "card": card}),
              flush=True)
    if args.deblock:
        d = torch.load(args.deblock)
        planes = [p.to(dev) for p in d["planes"]]
        runs = chip_smoke.deblock_times(
            torch, deblock, planes, d["v_on"].to(dev), d["h_on"].to(dev),
            d["levels"], d["bit_depth"], d["split16"].to(dev), plain=False)
        for r in runs:
            print(json.dumps({"root": args.root, "kernel": "deblock_edges",
                              **{k: v for k, v in r.items()
                                 if k != "plain_ms"},
                              "bound_share": r["bound_us"] / r["device_us"],
                              "card": card}), flush=True)
        print(json.dumps({
            "root": args.root, "kernel": "deblock_edges", "plane": "frame",
            "launches": len(runs),
            "device_us": sum(r["device_us"] for r in runs),
            "bound_us": sum(r["bound_us"] for r in runs), "card": card}),
              flush=True)
    if args.probe:
        d = torch.load(args.probe)
        planes = [p.to(dev) for p in d["planes"]]
        with forward_matrices(args.probe):
            calls = chip_smoke.capture_code_calls(torch, planes, d["q"],
                                                  d["bit_depth"])
        steps, seq_out, costs_sha = chip_smoke.capture_probe_sequence(
            torch, planes, d["q"], d["bit_depth"])
        sha = chip_smoke.outputs_sha256(seq_out)
        seq = chip_smoke.sequence_us(torch, intra_part, steps)
        for name, recs in chip_smoke.pred_merge_kinds(
                torch, intra_part, steps).items():
            for r in recs:
                print(json.dumps({"root": args.root, "kernel": name, **r,
                                  "card": card}), flush=True)
            print(json.dumps({
                "root": args.root, "kernel": name, "kind": "frame",
                "launches": sum(r["launches"] for r in recs),
                "frame_us": sum(r["frame_us"] for r in recs),
                "card": card}), flush=True)
        chip_smoke.replay_probe(torch, intra_part, steps)
        torch.cuda.synchronize()
        assert chip_smoke.outputs_sha256(seq_out) == sha, "replay differs"
        floor = (chip_smoke.empty_launch_us(torch)
                 if hasattr(_build.cuda_lib(), "av1_part_empty") else None)
        print(json.dumps({
            "root": args.root, "kernel": "probe", "kind": "sequence",
            "steps": len(steps), "frame_us": seq,
            "median_us": float(np.median(seq)), "outputs_sha256": sha,
            "region_costs_sha256": costs_sha, "empty_launch_us": floor,
            "card": card}), flush=True)
        kinds = chip_smoke.code_kinds(torch, intra_part, calls)
        for r in kinds:
            print(json.dumps({"root": args.root, "kernel": "part_code", **r,
                              "card": card}), flush=True)
        print(json.dumps({
            "root": args.root, "kernel": "part_code", "kind": "frame",
            "launches": sum(r["launches"] for r in kinds),
            "frame_us": sum(r["frame_us"] for r in kinds), "card": card}),
              flush=True)
    if args.chain:
        d = torch.load(args.chain)
        planes = [p.to(dev) for p in d["planes"]]
        frames = [("8-bit", planes, d["q"], d["bit_depth"]),
                  ("10-bit", [p * 4 + 2 for p in planes], 72, 10)]
        with forward_matrices(args.chain):
            for label, pl, q, bd in frames:
                jobs = chip_smoke.capture_chain_jobs(torch, pl, q, bd)
                ct = chip_smoke.chain_times(torch, intra_part, jobs)
                print(json.dumps({
                    "root": args.root, "kernel": "part_chain",
                    "frame": label, "shape": list(pl[0].shape),
                    **{f"{k}_us": ct[k] for k in ("all", "y", "u", "v")},
                    "floor_us": ct["floor_us"], "sha256": ct["sha256"],
                    "card": card}), flush=True)
    if args.cdef:
        d = torch.load(args.cdef)
        if "calls" in d:        # phase 7's launches
            cases = chip_smoke.cdef_path_cases(torch, d["calls"])
        else:
            cases = chip_smoke.cdef_cases(torch, (
                *(p.to(dev) for p in d["planes"]), d["skip8"].to(dev),
                *d["strengths"], d["damping"], d["bit_depth"]))
        recs = chip_smoke.cdef_times(torch, cdef, cases, plain=False)
        for r in recs:
            print(json.dumps({"root": args.root, "kernel": "cdef_filter",
                              "shape": list(cases[0][1][0].shape), **r,
                              "bound_share": r["bound_us"] / r["device_us"],
                              "card": card}), flush=True)
        if "calls" in d:
            for line in chip_smoke.cdef_path_summary(recs):
                print(json.dumps({"root": args.root, "kernel": "cdef_filter",
                                  **line, "card": card}), flush=True)
    for path in args.coder:
        sites = chip_smoke.load_coder_inputs(torch, inter_code, path, dev)
        times = chip_smoke.coder_times(torch, inter_code, sites, plain=False)
        frame_us = bound_frame = 0.0
        for (coefs, src, pred, plane), (dev_us, _) in zip(sites, times):
            key = chip_smoke.coder_key(src, plane)
            bound, by = chip_smoke.code_bounds(src.shape[0], plane.n)
            zero = int((inter_code.code_blocks(coefs, src, pred, plane)[0]
                        .flatten(1) == 0).all(1).sum())
            frame_us += dev_us
            bound_frame += bound
            print(json.dumps({
                "root": args.root, "kernel": "code_blocks", "file": path,
                "site": key, "bit_depth": plane.bit_depth,
                "device_us": dev_us, "bound_us": bound, "bound_by": by,
                "bound_share": bound / dev_us,
                "blocks_without_level": zero, "card": card}), flush=True)
        print(json.dumps({
            "root": args.root, "kernel": "code_blocks", "file": path,
            "site": "frame", "launches": len(sites),
            "device_ms": frame_us / 1e3, "bound_ms": bound_frame / 1e3,
            "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
