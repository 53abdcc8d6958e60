"""Command line of the PyTorch port: the JAX CLI's `render`, `render-bop`,
`render-training`, `demo`, `stream`, `pem`, `bop-eval` and `train`
subcommands, with its flags plus `--device` (default cuda):

  python -m sam6d_torch.cli.main render --cad_path obj.ply --output_dir OUT
  python -m sam6d_torch.cli.main demo --cad_path obj.ply --rgb_path rgb.png \
      --depth_path depth.png --cam_path camera.json --output_dir OUT
  python -m sam6d_torch.cli.main stream --cad_paths a.ply b.ply \
      --frames_dir FRAMES --cam_path camera.json --output_dir OUT
  python -m sam6d_torch.cli.main pem --output_dir OUT --cad_path obj.ply \
      --rgb_path rgb.png --depth_path depth.png --cam_path camera.json \
      --seg_path OUT/sam6d_results/detection_ism.json
  python -m sam6d_torch.cli.main render-bop --dataset_dir BOP/lmo \
      --dataset_name lmo --output_dir TEMPLATES
  python -m sam6d_torch.cli.main bop-eval --dataset_dir BOP/lmo \
      --dataset_name lmo --template_dir TEMPLATES --output_dir OUT
  python -m sam6d_torch.cli.main render-training --data_dir MEGAPOSE --source gso
  python -m sam6d_torch.cli.main train --data_dir MEGAPOSE --ckpt_dir CKPT

`render` writes OUT/templates (42 views of rgb_i.png, mask_i.png,
xyz_i.npy); `demo` renders, segments and matches (detection_ism.json,
vis_ism.png) and poses (detection_pem.json, vis_pem.png) under
OUT/sam6d_results; `stream` onboards every CAD and poses every
rgb*/depth* frame pair of FRAMES into OUT/results.jsonl; `pem` is demo.sh's
stage 3 on a given detection json; `render-bop` writes the 42 views of every
object of a BOP dataset to TEMPLATES/{dataset}/obj_{id:06d}; `bop-eval`
runs ISM over the dataset's test frames into OUT/ism_{dataset}.json
(BOP-23) and PEM on those detections (or --seg_path) into
OUT/sam6dtpu_{dataset}-test.csv (BOP19), the file names the JAX package
writes; with --num_shards N each --shard writes a rank file and
--merge_shards joins them; `render-training` writes the two training
views of every GSO (or ShapeNetCore) model of a MegaPose tree to
MEGAPOSE/MegaPose-GSO/templates/{gso_id}; `train` trains PEM on the tree's
shards (PEMTrainer, batch TrainConfig.batch_size, --data_workers loader
threads), logs the running metric means every TrainConfig.log_every steps
and writes CKPT/step_{step:08d}.pt (every checkpoint_every steps and at the
end), starting the backbone from --mae_ckpt when given; it exits with 2 when
the tree holds no shard. --sam_ckpt, --dinov2_ckpt and --pem_ckpt
take the reference checkpoint files (`demo --segmentor_model fastsam`
reads --sam_ckpt as the FastSAM checkpoint, as the JAX CLI does); without
them the networks run seeded random weights (a smoke of the data path, not
an estimate).
"""
from __future__ import annotations

import argparse
import os


def _sam_state_dict(path, cfg):
    if not path:
        return None
    from ..models.sam import SAM
    from ..weights.sam import load_reference_checkpoint
    net = SAM(cfg)
    load_reference_checkpoint(path, net)
    return net.state_dict()


def _dinov2_state_dict(path, cfg):
    if not path:
        return None
    from ..models.dinov2 import DINOv2
    from ..weights.dinov2 import load_reference_checkpoint
    net = DINOv2(cfg.img_size, cfg.patch_size, cfg.embed_dim, cfg.depth, cfg.num_heads)
    load_reference_checkpoint(path, net)
    return net.state_dict()


def _fastsam_state_dict(path):
    """A FastSAM checkpoint (ultralytics names) -> port weights, the
    network sized from the file (FastSAM-x for FastSAM-x.pt)."""
    if not path:
        return None
    from ..models.fastsam import FastSAMNet
    from ..weights.fastsam import fastsam_arch, load_reference_checkpoint, reference_state_dict
    sd = reference_state_dict(path)
    widths, depths = fastsam_arch(sd)
    net = FastSAMNet(widths=widths, depths=depths)
    load_reference_checkpoint(sd, net)
    return net.state_dict()


def _pem_state_dict(path, cfg):
    if not path:
        return None
    from ..models.pem import PEMNet
    from ..weights.pem import load_reference_checkpoint
    net = PEMNet(cfg)
    load_reference_checkpoint(path, net)
    return net.state_dict()


def _require_device(device: str) -> None:
    """Fail at once, and say why, when a CUDA device is asked for and there
    is none: the entry points never fall back to the CPU on their own."""
    import torch
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {device}: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")


def cmd_render(args):
    from ..core.config import default_config
    from ..render.templates import render_custom_templates
    cfg = default_config()
    out = render_custom_templates(args.cad_path, args.output_dir,
                                  level=cfg.render.template_level,
                                  image_size=cfg.render.image_size, device=args.device)
    print(f"templates written to {out}")


def cmd_render_bop(args):
    from ..render.templates import render_bop_templates
    _require_device(args.device)
    obj_ids = [int(x) for x in args.obj_ids] if args.obj_ids else None
    dirs = render_bop_templates(args.dataset_dir, args.output_dir, args.dataset_name,
                                level=args.level, obj_ids=obj_ids, device=args.device)
    print(f"{len(dirs)} objects -> {os.path.join(args.output_dir, args.dataset_name)}")


def cmd_render_training(args):
    from ..render.templates import render_gso_templates, render_shapenet_templates
    _require_device(args.device)
    idx = [int(x) for x in args.obj_indices] if args.obj_indices else None
    fn = render_gso_templates if args.source == "gso" else render_shapenet_templates
    dirs = fn(args.data_dir, obj_indices=idx, device=args.device)
    print(f"{len(dirs)} template dirs rendered ({args.source})")


def cmd_train(args):
    import sys

    import torch

    from ..core import config
    from ..core.checkpoint import save_train_state
    from ..core.profiling import LogBuffer, StageTimer
    from ..data.megapose import MegaPoseDataset
    from ..data.prefetch import PrefetchLoader
    from ..train.trainer import PEMTrainer, batch_to_device
    from ..weights.pem import mae_vit_state_dict

    _require_device(args.device)
    cfg = config.default_config()
    t = cfg.train
    ds = MegaPoseDataset(args.data_dir, img_size=cfg.pem.img_size,
                         n_sample_observed=cfg.pem.n_sample_observed_point,
                         n_sample_template=cfg.pem.n_sample_template_point)
    if len(ds) == 0:
        print(f"no MegaPose shards found under {args.data_dir}", file=sys.stderr)
        raise SystemExit(2)
    trainer = PEMTrainer(cfg, seed=t.seed, device=args.device)
    pretrained = (mae_vit_state_dict(args.mae_ckpt, cfg.pem.vit.depth)
                  if args.mae_ckpt else None)
    state = trainer.init_state(pretrained_vit=pretrained)
    noise = torch.Generator().manual_seed(t.seed)
    buf, timer = LogBuffer(), StageTimer(args.device)
    # batch assembly in worker threads overlaps the device step
    loader = PrefetchLoader(lambda r: ds.sample_batch(t.batch_size, r),
                            num_workers=args.data_workers, depth=2 * args.data_workers,
                            seed=t.seed + 1)
    try:
        for it in range(args.iters):
            with timer.stage("data"):
                batch = batch_to_device(loader.get(), args.device)
            with timer.stage("step"):
                state, metrics = trainer.step(state, batch, generator=noise)
            buf.update({k: float(v) for k, v in metrics.items()})
            if (it + 1) % t.log_every == 0:
                print(f"iter {it + 1}: " + " ".join(
                    f"{k}={v:.4f}" for k, v in sorted(buf.average().items())), flush=True)
                buf.clear()
            if (it + 1) % t.checkpoint_every == 0:
                save_train_state(args.ckpt_dir, it + 1, state)
    finally:
        loader.close()
    path = save_train_state(args.ckpt_dir, args.iters, state)
    print("stage means (ms): " + ", ".join(
        f"{k} {1e3 * v:.1f}" for k, v in timer.summary().items()) + f"; checkpoint -> {path}")


def cmd_demo(args):
    import dataclasses
    from ..core.config import default_config
    from ..pipelines.demo import run_demo

    cfg = default_config()
    if args.segmentor_model != "sam":
        cfg = dataclasses.replace(
            cfg, ism=dataclasses.replace(cfg.ism, segmentor=args.segmentor_model))
    results = run_demo(
        cfg, args.cad_path, args.rgb_path, args.depth_path, args.cam_path,
        args.output_dir,
        dinov2_state_dict=_dinov2_state_dict(args.dinov2_ckpt, cfg.ism.dinov2),
        sam_state_dict=(_fastsam_state_dict(args.sam_ckpt)
                        if cfg.ism.segmentor == "fastsam"
                        else _sam_state_dict(args.sam_ckpt, cfg.ism.sam)),
        pem_state_dict=_pem_state_dict(args.pem_ckpt, cfg.pem),
        det_score_thresh=args.det_score_thresh,
        skip_render=args.skip_render,
        stability_score_thresh=args.stability_score_thresh,
        device=args.device,
    )
    print(f"{len(results['ism'])} detections, {len(results['pem'])} poses "
          f"-> {os.path.join(args.output_dir, 'sam6d_results')}")


def cmd_stream(args):
    """Multi-object streaming serving: render (if missing) and onboard every
    CAD once, then one segmentation, one multi-object scoring and one
    batched PEM run per frame; writes results.jsonl and prints the
    throughput summary."""
    import dataclasses
    import glob
    import json

    import numpy as np
    from PIL import Image

    from ..core.config import default_config
    from ..data.mesh import load_mesh
    from ..data.prefetch import iter_prefetched
    from ..pipelines.ism import ISMPipeline
    from ..pipelines.pem import PEMPipeline
    from ..pipelines.sam_amg import SAMSegmentor
    from ..pipelines.streaming import MultiObjectStream
    from ..render.templates import render_templates

    cfg = default_config()
    if args.proposals:
        cfg = dataclasses.replace(cfg, ism=dataclasses.replace(
            cfg.ism, sam=dataclasses.replace(cfg.ism.sam, max_proposals=args.proposals)))
    os.makedirs(args.output_dir, exist_ok=True)
    dev = args.device
    seg = SAMSegmentor(cfg.ism.sam, state_dict=_sam_state_dict(args.sam_ckpt, cfg.ism.sam),
                       device=dev)
    ism = ISMPipeline(cfg.ism, state_dict=_dinov2_state_dict(args.dinov2_ckpt, cfg.ism.dinov2),
                      device=dev, segmentor=seg)
    pem = PEMPipeline(cfg.pem, state_dict=_pem_state_dict(args.pem_ckpt, cfg.pem), device=dev)
    stream = MultiObjectStream(ism, pem, det_score_thresh=args.det_score_thresh)
    rng = np.random.RandomState(0)
    for i, cad in enumerate(args.cad_paths):
        obj_dir = os.path.join(args.output_dir, f"obj_{i}")
        tdir = os.path.join(obj_dir, "templates")
        mesh = load_mesh(cad)
        if not os.path.isdir(tdir):
            render_templates(mesh, obj_dir, level=cfg.ism.template_level,
                             image_size=cfg.render.image_size, device=dev)
        # CAD in mm -> sample clouds in meters, as run_demo takes them
        stream.onboard_object(
            i, tdir, mesh.sample(cfg.pem.n_sample_model_point, rng) / 1000.0,
            ism_points=mesh.sample(cfg.ism.matching.pointcloud_sample_num, rng) / 1000.0)

    with open(args.cam_path) as f:
        cam = json.load(f)
    K = np.array(cam["cam_K"], np.float32).reshape(3, 3)
    depth_scale = float(cam.get("depth_scale", 1.0))
    rgbs = sorted(glob.glob(os.path.join(args.frames_dir, "rgb*.png")))
    if args.max_frames:
        rgbs = rgbs[:args.max_frames]
    out_path = os.path.join(args.output_dir, "results.jsonl")

    def frames():
        for rp in rgbs:
            dp = os.path.join(os.path.dirname(rp),
                              os.path.basename(rp).replace("rgb", "depth", 1))
            rgb = np.array(Image.open(rp).convert("RGB"))
            depth = np.array(Image.open(dp)).astype(np.float32)
            yield rp, rgb, depth

    names = []

    def items():
        # PNG decode in the prefetch thread; process_stream keeps one frame
        # in flight (frame t+1's segmentation queued while the host drives
        # frame t's PEM tail)
        for rp, rgb, depth in iter_prefetched(frames(), depth=2):
            names.append(rp)
            yield rgb, depth, K, depth_scale

    with open(out_path, "w") as f:
        for j, res in enumerate(stream.process_stream(
                items(), depth_in_flight=0 if args.no_overlap else 1)):
            f.write(json.dumps(dict(frame=os.path.basename(names[j]), poses=res["poses"],
                                    ms=round(res["ms"], 1))) + "\n")
    tp = stream.throughput()
    tail = f", p50 {tp['p50_ms']} / p95 {tp['p95_ms']} ms" if "p95_ms" in tp else ""
    print(f"{tp['frames']} frames, {tp['poses']} poses, "
          f"{tp['ms_per_frame']} ms/frame{tail} -> {out_path}")


def cmd_pem(args):
    from ..pipelines.pem import PEMConfig, run_demo_pem

    cfg = PEMConfig()
    results = run_demo_pem(
        cfg, args.output_dir, args.cad_path, args.rgb_path, args.depth_path,
        args.cam_path, args.seg_path, state_dict=_pem_state_dict(args.pem_ckpt, cfg),
        det_score_thresh=args.det_score_thresh, device=args.device)
    print(f"{len(results)} poses -> "
          f"{os.path.join(args.output_dir, 'sam6d_results', 'detection_pem.json')}")


def cmd_bop_eval(args):
    """BOP evaluation (reference run_inference.py + test_bop.py)."""
    ism_json = os.path.join(args.output_dir, f"ism_{args.dataset_name}.json")
    pem_csv = os.path.join(args.output_dir, f"sam6dtpu_{args.dataset_name}-test.csv")
    if args.merge_shards:
        from ..pipelines.bop_eval import merge_ism_shards, merge_pem_shards
        if args.stage in ("ism", "all"):
            merge_ism_shards(ism_json, args.num_shards)
            print(f"merged {args.num_shards} ISM shards -> {ism_json}")
        if args.stage in ("pem", "all"):
            merge_pem_shards(pem_csv, args.num_shards)
            print(f"merged {args.num_shards} PEM shards -> {pem_csv}")
        return
    import json

    from ..core.config import default_config
    from ..data.bop import load_bop_objects
    from ..pipelines.bop_eval import run_ism_bop_eval, run_pem_bop_eval
    from ..pipelines.ism import ISMPipeline
    from ..pipelines.pem import PEMPipeline
    from ..pipelines.sam_amg import SAMSegmentor

    _require_device(args.device)
    cfg = default_config()
    dev = args.device
    objects = load_bop_objects(os.path.join(args.dataset_dir, args.models_dir),
                               template_root=args.template_dir,
                               dataset_name=args.dataset_name)
    os.makedirs(args.output_dir, exist_ok=True)
    shards = dict(shard=args.shard, num_shards=args.num_shards)
    if args.stage in ("ism", "all"):
        seg = SAMSegmentor(cfg.ism.sam, state_dict=_sam_state_dict(args.sam_ckpt, cfg.ism.sam),
                           device=dev)
        ism = ISMPipeline(cfg.ism, state_dict=_dinov2_state_dict(args.dinov2_ckpt,
                                                                 cfg.ism.dinov2),
                          device=dev, segmentor=seg)
        if args.onboarding == "pbr":
            ism.onboard_bop_objects_pbr(
                args.dataset_dir, [o.obj_id for o in objects],
                cache_path=os.path.join(args.output_dir, "descriptors_pbr.npz"),
                reset_descriptors=args.reset_descriptors)
        else:
            ism.onboard_bop_objects(
                objects, cache_path=os.path.join(args.output_dir, "descriptors.npz"),
                reset_descriptors=args.reset_descriptors)
        run_ism_bop_eval(ism, args.dataset_dir, objects, ism_json,
                         dataset_name=args.dataset_name, max_frames=args.max_frames,
                         **shards)
        print(f"ISM results -> {ism_json}")
    if args.stage in ("pem", "all"):
        with open(args.seg_path or ism_json) as f:
            detections = json.load(f)
        pem = PEMPipeline(cfg.pem, state_dict=_pem_state_dict(args.pem_ckpt, cfg.pem),
                          device=dev)
        run_pem_bop_eval(pem, args.dataset_dir, objects, detections, pem_csv,
                         max_frames=args.max_frames, **shards)
        print(f"PEM results -> {pem_csv}")


def build_parser():
    p = argparse.ArgumentParser(prog="sam6d_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    device = argparse.ArgumentParser(add_help=False)
    device.add_argument("--device", default="cuda",
                        help="torch device, e.g. cuda, cuda:1 or cpu")
    ckpts = argparse.ArgumentParser(add_help=False)
    ckpts.add_argument("--sam_ckpt", default=os.environ.get("SAM_CKPT"))
    ckpts.add_argument("--dinov2_ckpt", default=os.environ.get("DINOV2_CKPT"))
    ckpts.add_argument("--pem_ckpt", default=os.environ.get("PEM_CKPT"))
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--output_dir", required=True)
    common.add_argument("--cad_path", required=True)
    io = argparse.ArgumentParser(add_help=False, parents=[ckpts])
    io.add_argument("--rgb_path", required=True)
    io.add_argument("--depth_path", required=True)
    io.add_argument("--cam_path", required=True)
    io.add_argument("--det_score_thresh", type=float, default=0.2)

    pr = sub.add_parser("render", parents=[common, device],
                        help="CAD -> 42 template views (rgb, mask, xyz)")
    pr.set_defaults(fn=cmd_render)

    prb = sub.add_parser("render-bop", parents=[device],
                         help="the 42 template views of every object of a BOP dataset")
    prb.add_argument("--dataset_dir", required=True)
    prb.add_argument("--dataset_name", required=True)
    prb.add_argument("--output_dir", required=True)
    prb.add_argument("--level", type=int, default=0)
    prb.add_argument("--obj_ids", nargs="*", default=None)
    prb.set_defaults(fn=cmd_render_bop)

    prt = sub.add_parser("render-training", parents=[device],
                         help="the two training views of every model of a MegaPose tree")
    prt.add_argument("--data_dir", required=True,
                     help="MegaPose root (contains MegaPose-GSO / MegaPose-ShapeNetCore)")
    prt.add_argument("--source", choices=["gso", "shapenet"], required=True)
    prt.add_argument("--obj_indices", nargs="*", default=None)
    prt.set_defaults(fn=cmd_render_training)

    pd = sub.add_parser("demo", parents=[common, io, device],
                        help="render -> ISM -> PEM on one RGB-D frame")
    pd.add_argument("--skip_render", action="store_true")
    pd.add_argument("--segmentor_model", default="sam", choices=["sam", "fastsam"])
    pd.add_argument("--stability_score_thresh", type=float, default=0.97)
    pd.set_defaults(fn=cmd_demo)

    pp = sub.add_parser("pem", parents=[common, io, device],
                        help="PEM stage: detections -> 6D poses")
    pp.add_argument("--seg_path", required=True)
    pp.set_defaults(fn=cmd_pem)

    ps = sub.add_parser("stream", parents=[ckpts, device],
                        help="multi-object serving: onboard N CAD models, then pose "
                             "every rgb/depth frame pair in --frames_dir")
    ps.add_argument("--cad_paths", nargs="+", required=True)
    ps.add_argument("--frames_dir", required=True,
                    help="directory of rgb*.png with matching depth*.png")
    ps.add_argument("--cam_path", required=True)
    ps.add_argument("--output_dir", default="outputs/stream")
    ps.add_argument("--max_frames", type=int, default=None)
    ps.add_argument("--no_overlap", action="store_true",
                    help="synchronous per-frame processing (no frame in flight)")
    ps.add_argument("--proposals", type=int, default=None,
                    help="override the AMG proposal capacity")
    ps.add_argument("--det_score_thresh", type=float, default=0.2)
    ps.set_defaults(fn=cmd_stream)

    pb = sub.add_parser("bop-eval", parents=[ckpts, device],
                        help="BOP evaluation: ISM over the test frames (BOP-23 json), "
                             "PEM on its detections (BOP19 csv)")
    pb.add_argument("--dataset_dir", required=True)
    pb.add_argument("--dataset_name", required=True)
    pb.add_argument("--template_dir", default=None,
                    help="render-bop's output dir (the PEM stage and --onboarding "
                         "render read the templates there)")
    pb.add_argument("--models_dir", default="models")
    pb.add_argument("--output_dir", default="outputs/bop")
    pb.add_argument("--stage", default="all", choices=["ism", "pem", "all"])
    pb.add_argument("--seg_path", default=None,
                    help="detections for the PEM stage (default: the ISM stage's json)")
    pb.add_argument("--max_frames", type=int, default=None)
    pb.add_argument("--shard", type=int, default=0)
    pb.add_argument("--num_shards", type=int, default=1)
    pb.add_argument("--merge_shards", action="store_true",
                    help="merge existing rank files instead of evaluating")
    pb.add_argument("--onboarding", default="pbr", choices=["pbr", "render"],
                    help="ISM template source: mined train_pbr crops (the reference "
                         "default, ISM_sam.yaml:28) or rendered templates")
    pb.add_argument("--reset_descriptors", action="store_true")
    pb.set_defaults(fn=cmd_bop_eval)

    pt = sub.add_parser("train", parents=[device],
                        help="PEM training on MegaPose shards")
    pt.add_argument("--data_dir", required=True)
    pt.add_argument("--ckpt_dir", default="checkpoints/pem")
    pt.add_argument("--iters", type=int, default=600_000)
    pt.add_argument("--mae_ckpt", default=os.environ.get("MAE_CKPT"))
    pt.add_argument("--data_workers", type=int, default=8)
    pt.set_defaults(fn=cmd_train)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
