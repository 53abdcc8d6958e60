"""Deployment artifacts of the port (`torch.export`): see export.py."""
from .export import (export_dinov2_describe, export_fn, export_pem_infer,
                     export_sam_decode, load_exported, pem_example_inputs,
                     save_exported)

__all__ = ["export_fn", "save_exported", "load_exported", "export_pem_infer",
           "pem_example_inputs", "export_sam_decode", "export_dinov2_describe"]
