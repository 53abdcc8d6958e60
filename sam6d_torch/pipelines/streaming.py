"""Multi-object streaming serving: N CAD models x a continuous RGB-D feed.

Port of `sam6d_tpu/pipelines/streaming.py`. The reference pipeline poses one
object per run (`run_inference_custom.py` takes a single --cad_path);
serving wants every onboarded object matched and posed per frame:

- onboarding stacks every object's ISM template descriptors
  (`ISMPipeline.set_reference_data`: the scoring is natively multi-object)
  and its PEM template caches into (O, ...) tensors on the device;
- per frame: one AMG pass, one multi-object ISM scoring (argmax over
  objects + per-object NMS), then ONE batched PEM run with each
  detection's templates gathered on the device by object index
  (`PEMPipeline.dispatch_frame_multi`).

Order on the device. PyTorch queues work on one CUDA stream in the order it
is launched, as JAX dispatches it. `process_stream` keeps the JAX package's
order: frame t's detections are read back and its PEM batch launched
(phase a) before frame t+1's segmentation is queued, and only then does the
host wait for frame t's poses (phase b). `submit_frame` waits on nothing:
the uploads go through pinned memory, NMS runs to its fixed point in one
kernel, and the describe is sized on the device by a CUDA graph of
conditional nodes (built, with every kernel's first launch, by a warm-up
frame at the end of the onboarding: `finish_onboarding`). The
host reads per frame are phase a's (K, 12) packed read and bitpacked mask
read and phase b's (n, 13) pose read; the (O,) model radii are read once,
at the onboarding.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.rle import rle_encode_coco
from .ism import ISMPipeline
from .pem import PEMPipeline

def _pow2_bucket(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def pack_mask_bits(masks: torch.Tensor) -> torch.Tensor:
    """(b, H, W) bool, W a multiple of 8 -> (b, H, W / 8) uint8, most
    significant bit first: the bytes of np.packbits(axis=-1), made on the
    device with integer shifts."""
    b, H, W = masks.shape
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=masks.device)
    bits = masks.reshape(b, H, W // 8, 8).to(torch.uint8) << shifts
    return bits.sum(-1, dtype=torch.uint8)    # disjoint bits: the sum is the OR


class MultiObjectStream:
    """Onboard once, then serve a stream of frames."""

    def __init__(self, ism: ISMPipeline, pem: PEMPipeline,
                 det_score_thresh: float = 0.2):
        self.ism = ism
        self.pem = pem
        self.det_score_thresh = det_score_thresh
        self._objs: List[Dict] = []
        self._finalized = False
        self.stats = dict(frames=0, detections=0, poses=0, seconds=0.0)
        self._frame_s: List[float] = []  # steady-state per-frame cadence
        self._pending: List = []         # submitted, not yet completed
        self._last_done: Optional[float] = None

    # ------------------------------------------------------------ onboarding

    def onboard_object(self, obj_id, template_dir: str,
                       model_points: np.ndarray,
                       num_templates: int = 42,
                       poses: Optional[np.ndarray] = None,
                       ism_points: Optional[np.ndarray] = None) -> None:
        """Register one object from its rendered template dir (rgb_*.png /
        mask_*.png / xyz_*.npy views) + CAD sample points (meters,
        n_sample_model_point rows). `ism_points` optionally gives the ISM
        geometric score another (usually denser) cloud."""
        assert not self._finalized, "onboard before the first frame"
        ref = self.ism.onboard_templates_from_dir(
            template_dir, num_templates=num_templates, poses=poses)
        templates = self.pem.onboard_templates(self.pem.load_template_views(template_dir))
        ism_pts = model_points if ism_points is None else ism_points
        dev = self.pem.device
        self._objs.append(dict(
            obj_id=obj_id,
            cls=ref["descriptors"][0],
            appe=ref["appe_descriptors"][0],
            poses_R=ref["poses_R"],
            templates=templates,
            model=torch.as_tensor(model_points.astype(np.float32), device=dev),
            cloud=torch.as_tensor(ism_pts.astype(np.float32), device=self.ism.device),
        ))

    def finish_onboarding(self, frame_hw=(480, 640)) -> None:
        """Stack the onboarded objects and make what the frames reuse: the
        model radii, and one warm-up of the frame chain on a blank frame of
        `frame_hw` (ISMPipeline.prepare_frames: the describe graph, each
        kernel's loading, the geometry's constants). The first submit_frame
        does it when the caller has not; a frame of another size uploads
        its own constants at its first call."""
        self._finalize(frame_hw)

    def _finalize(self, frame_hw=(480, 640)) -> None:
        if self._finalized:
            return
        assert self._objs, "no objects onboarded"
        # per-object template pose sets: one (T, 3, 3) set when every object
        # shares it, else the (O, T, 3, 3) stack, so the viewpoint-dependent
        # geometric score uses each object's own poses
        poses = [o["poses_R"] for o in self._objs]
        if all(p.shape == poses[0].shape and torch.equal(p, poses[0]) for p in poses[1:]):
            poses_R = poses[0]
        else:
            assert all(p.shape == poses[0].shape for p in poses), \
                "onboarded objects must use the same number of template views"
            poses_R = torch.stack(poses)
        self.ism.set_reference_data(
            torch.stack([o["cls"] for o in self._objs]),
            torch.stack([o["appe"] for o in self._objs]),
            poses_R)
        self._clouds = torch.stack([o["cloud"] for o in self._objs])
        self._model_all = torch.stack([o["model"] for o in self._objs])
        self._radii = self.pem.model_radii(self._model_all)
        self._templates_all = {
            k: torch.stack([o["templates"][k] for o in self._objs])
            for k in self._objs[0]["templates"]}
        self.ism.prepare_frames(self._clouds, frame_hw)
        self._finalized = True

    # --------------------------------------------------------------- serving

    def submit_frame(self, rgb: np.ndarray, depth: np.ndarray,
                     K: np.ndarray, depth_scale: float = 1.0,
                     seed: int = 1) -> None:
        """Queue the device chain (AMG + multi-object scoring) of one frame
        and enqueue it for complete_frame(). Returns once the work is queued,
        before any result exists: nothing in it waits for the card (after
        finish_onboarding, which the first call runs otherwise)."""
        self._finalize(np.shape(rgb)[:2])
        t0 = time.time()
        dev = self.ism.match_frame_device(rgb, depth, K, depth_scale,
                                          self._clouds,
                                          apply_nms_per_object=True)
        self._pending.append((dev, rgb, depth, K, depth_scale, seed, t0))

    def complete_frame(self) -> Dict:
        """Wait for the oldest submitted frame, run the host tail (detection
        assembly, RLE, PEM batch) and account stats. Returns
        dict(detections, poses, ms)."""
        return self._complete_phase_b(self._complete_phase_a())

    def _complete_phase_a(self):
        """Read the oldest frame's detections back, build them and LAUNCH its
        PEM batch. Kept apart from _complete_phase_b so the serving loop can
        queue the NEXT frame's segmentation before it waits: work on the
        stream runs in launch order, so a PEM launched after frame t+1's AMG
        would wait behind it."""
        dev, rgb, depth, K, depth_scale, seed, t0 = self._pending.pop(0)
        tm = {}
        tt = time.perf_counter()
        # ONE small copy: the packed (K, 12) array carries [score,
        # object_id, valid, sem, appe, geo, vis, best_template, box x1 y1 x2
        # y2] (ISMPipeline.match_frame_device)
        pk = dev["packed"].cpu().numpy()
        scores, object_ids = pk[:, 0], pk[:, 1].astype(np.int32)
        boxes, idx = pk[:, 8:12], np.flatnonzero(pk[:, 2] > 0.5)
        tm["transfer_small_ms"] = (time.perf_counter() - tt) * 1e3
        tt = time.perf_counter()
        # gather ONLY the surviving masks on the device (a power-of-two
        # bucket of slots), then bitpack them before the copy: 8x fewer
        # bytes, and np.unpackbits restores them exactly
        masks = dev["masks"]
        if len(idx):
            bucket = _pow2_bucket(len(idx), int(masks.shape[0]))
            idx_pad = np.zeros(bucket, np.int64)
            idx_pad[:len(idx)] = idx
            g = masks[torch.as_tensor(idx_pad, device=masks.device)] > 0.5
            if g.shape[-1] % 8 == 0:
                sel = np.unpackbits(pack_mask_bits(g).cpu().numpy(), axis=-1
                                    ).astype(bool)[:len(idx)]
            else:
                sel = g.cpu().numpy()[:len(idx)]
        else:
            sel = np.zeros((0, *masks.shape[1:]), bool)
        tm["transfer_masks_ms"] = (time.perf_counter() - tt) * 1e3
        tt = time.perf_counter()
        dets = []
        for j, i in enumerate(idx):
            mask = sel[j].astype(np.uint8)
            dets.append(dict(
                object_id=int(object_ids[i]),
                score=float(scores[i]),
                bbox=[float(x) for x in boxes[i]],
                segmentation=rle_encode_coco(mask),
                mask=mask,  # the raw mask rides along so PEM skips the decode
            ))
        tm["rle_ms"] = (time.perf_counter() - tt) * 1e3
        tt = time.perf_counter()
        pem_state = self.pem.dispatch_frame_multi(
            rgb, depth, K, depth_scale, dets,
            self._model_all, self._templates_all,
            det_score_thresh=self.det_score_thresh, seed=seed, model_radii=self._radii)
        tm["pem_dispatch_ms"] = (time.perf_counter() - tt) * 1e3
        return dict(pem_state=pem_state, dets=dets, t0=t0, tm=tm)

    def _complete_phase_b(self, st) -> Dict:
        """Wait for the PEM results of a _complete_phase_a handle, account
        stats, return the frame result."""
        tm = st["tm"]
        tt = time.perf_counter()
        poses, _ = self.pem.finalize_frame_multi(st["pem_state"])
        tm["pem_ms"] = (time.perf_counter() - tt) * 1e3
        tm.update(getattr(self.pem, "last_timing", {}))
        self.last_timing = tm
        dets, t0 = st["dets"], st["t0"]
        now = time.time()
        # steady-state cadence: completion-to-completion interval (the
        # serving metric under pipelining; equals per-frame latency in the
        # synchronous path); the first frame is the warm-up
        if self.stats["frames"] == 0:
            self.stats["first_frame_s"] = now - t0
            self.stats["seconds"] += now - t0
        else:
            self._frame_s.append(now - self._last_done)
            self.stats["seconds"] += self._frame_s[-1]
        self._last_done = now
        self.stats["frames"] += 1
        self.stats["detections"] += len(dets)
        self.stats["poses"] += len(poses)
        for p in poses:
            p["object_id"] = self._objs[p["object_id"]]["obj_id"]
        return dict(detections=dets, poses=poses, ms=(now - t0) * 1e3)

    def process_frame(self, rgb: np.ndarray, depth: np.ndarray,
                      K: np.ndarray, depth_scale: float = 1.0,
                      seed: int = 1) -> Dict:
        """One RGB-D frame -> dict(detections, poses, ms), synchronous
        (submit + complete back to back). Detections carry the onboarded
        object indices; poses one dict per surviving detection (R row-major,
        t in mm, fused ISM*PEM score) with the caller's object ids."""
        self.submit_frame(rgb, depth, K, depth_scale, seed)
        return self.complete_frame()

    def process_stream(self, frames, depth_in_flight: int = 1):
        """Pipelined serving over an iterable of (rgb, depth, K, depth_scale)
        tuples, `depth_in_flight` frames in flight. Per step, the oldest
        frame's detections are read and its PEM batch launched (phase a)
        before the next frame's AMG is submitted, so frame t's PEM runs ahead
        of frame t+1's AMG on the stream; the host then waits for t's poses
        (phase b). Yields one result per frame, in order."""
        for item in frames:
            if len(self._pending) >= max(depth_in_flight, 1):
                st = self._complete_phase_a()
                self.submit_frame(*item)
                yield self._complete_phase_b(st)
            else:
                self.submit_frame(*item)
        while self._pending:
            yield self.complete_frame()

    def throughput(self) -> Dict:
        """Steady-state stats exclude the first frame (the warm-up)."""
        s = self.stats
        warm_frames = max(s["frames"] - 1, 0)
        warm_s = s["seconds"] - s.get("first_frame_s", 0.0)
        out = dict(frames=s["frames"], poses=s["poses"],
                   first_frame_ms=round(1e3 * s.get("first_frame_s", 0.0), 1))
        if warm_frames:
            out["fps"] = round(warm_frames / max(warm_s, 1e-9), 3)
            out["ms_per_frame"] = round(1e3 * warm_s / warm_frames, 2)
        else:
            out["fps"] = 0.0
            out["ms_per_frame"] = 0.0
        # latency percentiles over the steady-state frames (serving
        # contracts are per-frame tail latency, not throughput)
        if self._frame_s:
            ms = np.sort(np.asarray(self._frame_s)) * 1e3
            out["p50_ms"] = round(float(np.percentile(ms, 50)), 2)
            out["p95_ms"] = round(float(np.percentile(ms, 95)), 2)
            out["p99_ms"] = round(float(np.percentile(ms, 99)), 2)
        return out

    def check_latency_slo(self, p95_budget_ms: float) -> Dict:
        """Assertable SLO summary: steady-state p95 against a budget."""
        tp = self.throughput()
        p95 = tp.get("p95_ms")
        return dict(p95_ms=p95, budget_ms=p95_budget_ms,
                    ok=p95 is not None and p95 <= p95_budget_ms)
