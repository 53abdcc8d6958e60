"""Command line of the PyTorch port. One subcommand so far, the PEM stage
(demo.sh stage 3), with the flags of the JAX CLI's `pem` plus `--device`:

  python -m sam6d_torch.cli.main pem --output_dir OUT --cad_path obj.ply \
      --rgb_path rgb.png --depth_path depth.png --cam_path camera.json \
      --seg_path OUT/sam6d_results/detection_ism.json [--pem_ckpt pem.pth]

It reads OUT/templates (rgb_i.png, mask_i.png, xyz_i.npy) and writes
OUT/sam6d_results/detection_pem.json. Without --pem_ckpt the network runs
seeded random weights (a smoke of the data path, not a pose estimate).
"""
from __future__ import annotations

import argparse
import os


def cmd_pem(args):
    from ..pipelines.pem import PEMConfig, run_demo_pem

    cfg = PEMConfig()
    state_dict = None
    if args.pem_ckpt:
        from ..models.pem import PEMNet
        from ..weights.pem import load_reference_checkpoint
        net = PEMNet(cfg)
        load_reference_checkpoint(args.pem_ckpt, net)
        state_dict = net.state_dict()
    results = run_demo_pem(
        cfg, args.output_dir, args.cad_path, args.rgb_path, args.depth_path,
        args.cam_path, args.seg_path, state_dict=state_dict,
        det_score_thresh=args.det_score_thresh, device=args.device)
    print(f"{len(results)} poses -> "
          f"{os.path.join(args.output_dir, 'sam6d_results', 'detection_pem.json')}")


def build_parser():
    p = argparse.ArgumentParser(prog="sam6d_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pp = sub.add_parser("pem", help="PEM stage: detections -> 6D poses")
    pp.add_argument("--output_dir", required=True)
    pp.add_argument("--cad_path", required=True)
    pp.add_argument("--rgb_path", required=True)
    pp.add_argument("--depth_path", required=True)
    pp.add_argument("--cam_path", required=True)
    pp.add_argument("--seg_path", required=True)
    pp.add_argument("--det_score_thresh", type=float, default=0.2)
    pp.add_argument("--pem_ckpt", default=os.environ.get("PEM_CKPT"))
    # accepted for command-line parity with the JAX CLI; the PEM stage
    # does not read them
    pp.add_argument("--sam_ckpt", default=os.environ.get("SAM_CKPT"))
    pp.add_argument("--dinov2_ckpt", default=os.environ.get("DINOV2_CKPT"))
    pp.add_argument("--device", default="cuda",
                    help="torch device, e.g. cuda, cuda:1 or cpu")
    pp.set_defaults(fn=cmd_pem)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
