"""The seven-dataset BOP suite: `bop-eval` over the BOP-19/23 core datasets
(the reference's exp.sh; port of scripts/bop_suite.py), writing each
dataset's submission files under OUTPUT_DIR/{dataset}. Scenes shard across
hosts with --shard/--num_shards and merge with --merge_shards, as one
`bop-eval` call does; tless reads its models from models_cad.

  python -m sam6d_torch.cli.bop_suite --bop_root BOP --template_root TEMPLATES \
      --output_dir outputs/bop_suite [--datasets lmo ycbv] [--device cuda] \
      [--sam_ckpt ...] [--dinov2_ckpt ...] [--pem_ckpt ...]
"""
from __future__ import annotations

import argparse
import os

from ..data.bop import BOP_DATASETS
from .main import cmd_bop_eval


def build_parser():
    p = argparse.ArgumentParser(prog="sam6d_torch.cli.bop_suite")
    p.add_argument("--bop_root", required=True)
    p.add_argument("--template_root", required=True)
    p.add_argument("--output_dir", default="outputs/bop_suite")
    p.add_argument("--datasets", nargs="*", default=BOP_DATASETS)
    p.add_argument("--stage", default="all", choices=["ism", "pem", "all"])
    p.add_argument("--onboarding", default="pbr", choices=["pbr", "render"])
    p.add_argument("--shard", type=int, default=0)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--merge_shards", action="store_true")
    p.add_argument("--reset_descriptors", action="store_true")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--sam_ckpt", default=os.environ.get("SAM_CKPT"))
    p.add_argument("--dinov2_ckpt", default=os.environ.get("DINOV2_CKPT"))
    p.add_argument("--pem_ckpt", default=os.environ.get("PEM_CKPT"))
    p.add_argument("--device", default="cuda",
                   help="torch device, e.g. cuda, cuda:1 or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    for name in args.datasets:
        print(f"=== {name} ===", flush=True)
        cmd_bop_eval(argparse.Namespace(
            dataset_dir=os.path.join(args.bop_root, name), dataset_name=name,
            template_dir=args.template_root,
            models_dir="models_cad" if name == "tless" else "models",
            output_dir=os.path.join(args.output_dir, name), stage=args.stage,
            seg_path=None, max_frames=args.max_frames, shard=args.shard,
            num_shards=args.num_shards, merge_shards=args.merge_shards,
            onboarding=args.onboarding, reset_descriptors=args.reset_descriptors,
            sam_ckpt=args.sam_ckpt, dinov2_ckpt=args.dinov2_ckpt,
            pem_ckpt=args.pem_ckpt, device=args.device))


if __name__ == "__main__":
    main()
