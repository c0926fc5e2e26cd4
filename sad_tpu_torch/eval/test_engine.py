"""Dataset inference, COCO evaluation and pseudo-label generation (ref:
sad_tpu/eval/test_engine.py; detectron/lib/core/test_engine.py).

Images are batched onto the static test canvases as uint8 with their
content extents, normalised and decoded on the device, and the (N, 100)
results come back as COCO-format detection dicts: for RetinaNet, for Fast /
Faster / Mask / Keypoint R-CNN (generalized_rcnn, with FPN or single-scale:
C4, VGG) and for R-FCN ('rfcn', served as an R-CNN; sad_tpu's test_net sends
it to the RetinaNet decode, ROADMAP.md Queue 3). The canvases are those of
sad_tpu, FPN.COARSEST_STRIDE multiples for every model. Mask R-CNN's
kept masks are gathered to each detection's own class on the card, pasted
into the image frame and RLE-encoded on the host. Keypoint R-CNN's kept
heatmaps are decoded on the host (utils/keypoints.heatmaps_to_keypoints,
optionally OKS-NMS under KRCNN.NMS_OKS) into COCO keypoint triplets, with a
keypoint score by KRCNN.KEYPOINT_CONFIDENCE. ``test_net_on_dataset`` scores
them with the COCO evaluator (bbox, segm under MODEL.MASK_ON, keypoints
under MODEL.KEYPOINTS_ON), writes bbox_results.json, results.json and
timing.json (the host split of the loop), and with cfg.VIS renders each
image with its boxes, masks and keypoint skeletons.

Over the torchrun world (``multi_gpu``, test_net --multi-gpu-testing) each
rank serves a contiguous shard of the roidb, the counterpart of the
reference's --range subprocesses (test_engine.py:115-153) and of sad_tpu's
mesh batch sharding (sad_tpu/eval/test_engine.py:195-212); rank 0 merges
the detections in the one-process order (the landscape images in roidb
order, then the portrait ones), evaluates and writes the files.

Test-time augmentation (TEST.BBOX_AUG, TEST.MASK_AUG, TEST.KPS_AUG; ref:
test.py im_detect_bbox_aug:195-276, im_detect_mask_aug:410-478,
im_detect_keypoints_aug:582-665; sad_tpu/eval/test_engine.py:145-410): the
box pass runs once a transform, each image's candidates are UNION-merged and
post-processed on the host (eval/test_augmentation.postprocess_detections:
soft-NMS or NMS, box voting, the top DETECTIONS_PER_IM), the mask and
keypoint heads re-run on the merged boxes, then once a mask / keypoint
transform, and their outputs are combined by the configured heuristic.
Fast R-CNN (MODEL.FASTER_RCNN False) serves precomputed proposals attached
from TEST.PROPOSAL_FILES (eval/rpn_generator.add_proposals_to_roidb), one
file a TEST.DATASETS entry, before the roidb is sharded over the ranks.

Refused, each naming its ROADMAP.md note, where sad_tpu silently ignores the
option (a refusal is no different result): TEST.SOFT_NMS or TEST.BBOX_VOTE
without TEST.BBOX_AUG (sad_tpu applies them only in its bbox-aug branch),
TEST.PROPOSAL_FILES with MODEL.FASTER_RCNN True, aspect-ratio TTA (sad_tpu
refuses it too). RetinaNet ignores TTA, soft-NMS and voting, as sad_tpu's
RetinaNet branch does. Not ported yet, raising NotImplementedError naming
their ROADMAP.md item: the VOC, Cityscapes-mask and VID evaluators (Queue 1
item 9).

Dataset I/O is the port's copy of sad_tpu's host modules (sad_tpu_torch.data).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config.config import get_output_dir
from ..data.dataset import CocoDataset
from ..data.minibatch import compute_im_scale, load_image_bgr, resize_bgr_u8
from ..parallel.distributed import (
    barrier, broadcast_object, current, gather_objects, world_size,
)
from ..utils.keypoints import heatmaps_to_keypoints, nms_oks
from ..utils.segms import mask_to_rle, paste_mask_into_image
from .coco_eval import COCOEvaluator
from .inference import make_inference_fn
from . import test_augmentation
from ..models.model_builder import check_single_scale
from .rcnn_inference import make_aux_on_boxes_fn, make_rcnn_inference_fn, single_scale

logger = logging.getLogger(__name__)

# the host split of run_inference_on_roidb, in the order of a batch: with
# test-time augmentation the extra box passes (each a load, the model and
# the copy back), the host merge and post-processing, the mask / keypoint
# heads on the merged boxes and their TTA passes, and the combining
SPLIT_KEYS = ("load_resize", "device", "aug_box_passes", "aug_merge", "aug_aux_passes",
              "aug_combine", "mask_gather", "kps_copy", "kps_decode", "paste", "rle", "dicts",
              "vis")
# where sad_tpu and Detectron differ on this path (ROADMAP.md Queue 3)
_QUEUE3 = " (sad_tpu ignores it; ROADMAP.md Queue 3)"


def _test_canvas_shapes(cfg):
    """(landscape, portrait) canvases: short side from max(TEST.SCALES),
    long side from TEST.MAX_SIZE, both rounded up to COARSEST_STRIDE."""
    cs = cfg.FPN.COARSEST_STRIDE
    short = int(cs * np.ceil(max(cfg.TEST.SCALES) / float(cs)))
    long = int(cs * np.ceil(cfg.TEST.MAX_SIZE / float(cs)))
    long = max(long, short)
    return (short, long), (long, short)


def prepare_test_batch(cfg, entries: List[dict], canvas, target_scale: int = 0,
                       target_max_size: int = 0, hflip: bool = False,
                       images: Optional[List[np.ndarray]] = None) -> Dict[str, np.ndarray]:
    """uint8 BGR canvases plus per-image content extents ('content_hw'),
    original sizes ('im_hw') and scales ('im_scale'). ``target_scale`` /
    ``target_max_size`` override TEST.SCALES[0] / TEST.MAX_SIZE for a TTA
    pass, the scale clamped so that the content still fits the static canvas
    (sad_tpu/eval/test_engine.py:87; Detectron would enlarge the canvas,
    ROADMAP.md Queue 3); ``hflip`` mirrors the content, not the canvas.
    ``images``: the entries' BGR images already decoded (a TTA batch decodes
    them once for all its passes)."""
    ch, cw = canvas
    n = len(entries)
    data = np.zeros((n, ch, cw, 3), np.uint8)
    im_hw = np.zeros((n, 2), np.float32)
    content_hw = np.zeros((n, 2), np.float32)
    scales = np.zeros((n,), np.float32)
    for i, e in enumerate(entries):
        im_bgr = images[i] if images is not None else load_image_bgr(e["image"], False)
        scale = compute_im_scale(e["height"], e["width"], target_scale or cfg.TEST.SCALES[0],
                                 target_max_size or cfg.TEST.MAX_SIZE)
        scale = min(scale, ch / float(e["height"]), cw / float(e["width"]))
        im = resize_bgr_u8(im_bgr, scale)
        if hflip:
            im = im[:, ::-1]
        h, w = im.shape[:2]
        data[i, :h, :w] = im
        im_hw[i] = (e["height"], e["width"])
        content_hw[i] = (h, w)
        scales[i] = scale
    return {"data": data, "im_hw": im_hw, "im_scale": scales, "content_hw": content_hw}


# the R-CNN model types run_inference_on_roidb serves through make_rcnn_inference_fn
RCNN_SERVED = ("generalized_rcnn", "rfcn")


def _refuse_unported_inference(cfg) -> None:
    """Raise for what run_inference_on_roidb does not serve, before any work
    (dispatch by model type, sad_tpu/eval/test_engine.py:109-124; ref:
    im_detect_all branching, test.py:52-58)."""
    if cfg.MODEL.TYPE in ("retinanet", "distillation"):
        return  # TTA, soft-NMS and voting ignored, as sad_tpu's RetinaNet branch does
    if cfg.MODEL.TYPE == "rpn":
        raise ValueError("MODEL.TYPE 'rpn' makes proposals, not detections: serve it through "
                         "tools/test_net or eval/rpn_generator.generate_rpn_on_dataset")
    if cfg.MODEL.TYPE not in RCNN_SERVED:
        raise NotImplementedError(f"MODEL.TYPE={cfg.MODEL.TYPE!r} is not a model type of "
                                  "sad_tpu")
    if single_scale(cfg):
        check_single_scale(cfg)
    t = cfg.TEST
    if not t.BBOX_AUG.ENABLED:
        alone = [n for n, on in (("TEST.SOFT_NMS", t.SOFT_NMS.ENABLED),
                                 ("TEST.BBOX_VOTE", t.BBOX_VOTE.ENABLED)) if on]
        if alone:
            raise NotImplementedError(
                f"{' and '.join(alone)} without TEST.BBOX_AUG: sad_tpu applies them only "
                "inside its bbox-aug branch and ignores them otherwise" + _QUEUE3)
    if t.BBOX_AUG.ENABLED and ("UNION", "UNION", False) != (
            t.BBOX_AUG.SCORE_HEUR, t.BBOX_AUG.COORD_HEUR, t.BBOX_AUG.SCALE_SIZE_DEP):
        raise NotImplementedError("TEST.BBOX_AUG: only the UNION score and coordinate "
                                  "heuristics, without SCALE_SIZE_DEP, are served" + _QUEUE3)
    if t.PROPOSAL_FILES and cfg.MODEL.FASTER_RCNN:
        raise NotImplementedError("TEST.PROPOSAL_FILES with MODEL.FASTER_RCNN True: the RPN "
                                  "makes the proposals, the files would go unread" + _QUEUE3)
    if cfg.MODEL.RPN_ONLY:
        raise NotImplementedError("MODEL.RPN_ONLY with MODEL.TYPE 'generalized_rcnn': "
                                  "RPN-only serving is MODEL.TYPE 'rpn'" + _QUEUE3)
    if (t.BBOX_AUG.ENABLED and t.BBOX_AUG.ASPECT_RATIOS) or (
            cfg.MODEL.MASK_ON and t.MASK_AUG.ENABLED and t.MASK_AUG.ASPECT_RATIOS) or (
            cfg.MODEL.KEYPOINTS_ON and t.KPS_AUG.ENABLED and t.KPS_AUG.ASPECT_RATIOS):
        raise NotImplementedError(test_augmentation._ASPECT_RATIOS_REFUSED)
    if cfg.MODEL.MASK_ON and t.MASK_AUG.ENABLED and t.MASK_AUG.SCALE_SIZE_DEP:
        # the reference asserts this out too (test.py:421)
        raise NotImplementedError("Size dependent scaling not implemented for masks")


def _make_infer_fn(cfg, model):
    if cfg.KRCNN.KEYPOINT_CONFIDENCE not in ("bbox", "logit", "prob"):
        # fail before inference, not on the first emitted detection
        raise ValueError("KRCNN.KEYPOINT_CONFIDENCE must be 'logit', 'prob', or 'bbox'; got "
                         f"{cfg.KRCNN.KEYPOINT_CONFIDENCE!r}")
    _refuse_unported_inference(cfg)
    if cfg.MODEL.TYPE in RCNN_SERVED:
        # under TEST.BBOX_AUG the heads run on the merged boxes, not in the box passes
        return make_rcnn_inference_fn(cfg, model, aux_heads=not cfg.TEST.BBOX_AUG.ENABLED)
    return make_inference_fn(cfg, model)


def gather_class_masks(mask_prob: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """Each kept detection's own class channel of ``mask_prob`` (B, K, m, m,
    C) as (B, K, m, m) float32, on mask_prob's device: what the paste reads,
    without copying the other C - 1 channels to the host (sad_tpu copies the
    whole array and indexes ``[j, k, :, :, c]`` there). Invalid slots carry
    class 0 and gather the background channel, which nothing reads."""
    idx = classes.long()[:, :, None, None, None].expand(*mask_prob.shape[:4], 1)
    return torch.gather(mask_prob, 4, idx)[..., 0].float()


def _flip_boxes_imframe(boxes: np.ndarray, entries: List[dict]) -> np.ndarray:
    """(B, K, 4) boxes mirrored on each image's width (boxes.py flip_boxes)."""
    out = boxes.copy()
    for j, e in enumerate(entries):
        w = float(e["width"])
        out[j, :, 0] = w - boxes[j, :, 2] - 1.0
        out[j, :, 2] = w - boxes[j, :, 0] - 1.0
    return out


class _Batch:
    """One batch of run_inference_on_roidb on the device: the infer and aux
    functions, its entries, canvas and device, and the host split's clock."""

    def __init__(self, cfg, infer, aux, entries, canvas, dev, precomputed, split, clock):
        self.cfg, self.infer, self.aux = cfg, infer, aux
        self.entries, self.canvas, self.dev = entries, canvas, dev
        self.precomputed, self.split, self.clock = precomputed, split, clock
        self.images = None  # the entries' images, decoded once for every pass
        self.mark = clock()

    def lap(self, name: str) -> None:
        """The seconds since the last lap, added to ``name`` of the split."""
        now = self.clock()
        self.split[name] += now - self.mark
        self.mark = now

    def tensors(self, scale: int = 0, max_size: int = 0, hflip: bool = False):
        """The batch's images at a transform, on the device, with their
        proposals (flipped with the image) for Fast R-CNN: (host, tensors)."""
        if self.images is None:
            decoded = {path: load_image_bgr(path, False) for path in
                       {e["image"] for e in self.entries}}
            self.images = [decoded[e["image"]] for e in self.entries]
        host = prepare_test_batch(self.cfg, self.entries, self.canvas, scale, max_size, hflip,
                                  self.images)
        if self.precomputed:
            from ..data.rpn_minibatch import pad_proposals

            host["proposals"], host["prop_valid"] = pad_proposals(
                self.entries, max(self.cfg.TEST.PROPOSAL_LIMIT, 1), host["im_scale"],
                hflip=hflip)
        return host, {k: torch.from_numpy(v).to(self.dev) for k, v in host.items()}

    def boxes(self, t) -> Dict:
        """The model's detections on the batch's tensors ``t``: the device
        dict."""
        return self.infer(t["data"], t["im_hw"], t["im_scale"], t["content_hw"],
                          *((t["proposals"], t["prop_valid"]) if self.precomputed else ()))

    def aux_on(self, host, t, boxes: np.ndarray, valid: np.ndarray, hflip: bool = False):
        """The mask / keypoint heads on fixed (B, K, 4) image-frame boxes over
        the images of ``host`` / ``t`` (flipped with them): the device dict."""
        bx = _flip_boxes_imframe(boxes, self.entries) if hflip else boxes
        net = (bx * host["im_scale"][:, None, None]).astype(np.float32)
        return self.aux(t["data"], torch.from_numpy(net).to(self.dev),
                        torch.from_numpy(valid).to(self.dev), t["content_hw"])


def _merge_box_passes(cfg, batch: _Batch, chunk, base_out):
    """TEST.BBOX_AUG: the extra box passes, the per-image UNION merge and the
    host post-processing (sad_tpu/eval/test_engine.py:258-322): the merged
    (boxes, scores, classes, valid) numpy arrays, the top
    min(DETECTIONS_PER_IM, K) an image by score, padding zero."""
    keys = ("boxes", "scores", "classes", "valid")
    t_list = test_augmentation.bbox_aug_transforms(cfg)
    outs = [base_out]
    for t in t_list[1:]:
        _, tens = batch.tensors(int(t["scale"]), int(t["max_size"]), bool(t["hflip"]))
        o = batch.boxes(tens)
        outs.append({k: o[k].cpu().numpy() for k in keys})
    batch.lap("aug_box_passes")
    boxes = base_out["boxes"]
    kmax = boxes.shape[1]
    nb, ns = np.zeros_like(boxes), np.zeros_like(base_out["scores"])
    nc, nv = np.zeros_like(base_out["classes"]), np.zeros(base_out["valid"].shape, bool)
    flips = [bool(t["hflip"]) for t in t_list]
    for j, e in enumerate(chunk):
        per = [{"boxes": o["boxes"][j], "scores": o["scores"][j], "classes": o["classes"][j],
                "valid": o["valid"][j].astype(bool)} for o in outs]
        merged = test_augmentation.merge_aug_detections(per, im_w=float(e["width"]),
                                                        flipped_flags=flips)
        fb, fs, fc = test_augmentation.postprocess_detections(
            cfg, merged["boxes"], merged["scores"], merged["classes"],
            merged["valid"].astype(bool), cfg.MODEL.NUM_CLASSES)
        m = min(len(fs), kmax)
        order = np.argsort(-fs)[:m]
        nb[j, :m], ns[j, :m], nc[j, :m], nv[j, :m] = fb[order], fs[order], fc[order], True
    batch.lap("aug_merge")
    return nb, ns, nc, nv


def _aux_aug(cfg, batch: _Batch, aug, first, boxes, valid, classes, head: str):
    """TEST.MASK_AUG (``head`` 'mask') or TEST.KPS_AUG ('kps'): the head on
    the final boxes once a transform of aux_aug_transforms, combined with
    ``first`` (the identity pass's output) by the section's heuristic. Masks
    are gathered to their class on the card, then un-flipped on the host."""
    stacks, ds, us = [first], [False], [False]
    for t in test_augmentation.aux_aug_transforms(aug, cfg):
        host, tens = batch.tensors(int(t["scale"]), int(t["max_size"]), bool(t["hflip"]))
        o = batch.aux_on(host, tens, boxes, valid, hflip=bool(t["hflip"]))
        if head == "mask":
            out = gather_class_masks(o["mask_prob"], torch.from_numpy(classes).to(batch.dev))
            out = out.cpu().numpy()
            stacks.append(test_augmentation.flip_mask_probs(out) if t["hflip"] else out)
        else:
            out = o["kps_heatmaps"].cpu().numpy()
            stacks.append(test_augmentation.flip_heatmaps(out) if t["hflip"] else out)
        ds.append(bool(t["ds"]))
        us.append(bool(t["us"]))
    batch.lap("aug_aux_passes")
    if head == "mask":
        out = test_augmentation.combine_soft_masks(stacks, aug.HEUR)
    elif aug.SCALE_SIZE_DEP:
        out = test_augmentation.combine_heatmaps_size_dep(stacks, ds, us, boxes, aug.HEUR,
                                                          aug.AREA_TH)
    else:
        out = test_augmentation.combine_heatmaps(stacks, aug.HEUR)
    batch.lap("aug_combine")
    return out


def run_inference_on_roidb(cfg, model, roidb: List[dict],
                           contiguous_to_json: Dict[int, int],
                           batch_size: int = 8,
                           vis_dir: Optional[str] = None,
                           timing: Optional[Dict[str, float]] = None) -> List[Dict]:
    """COCO-format detection dicts for every image of roidb; with MODEL.MASK_ON
    each carries its mask as uncompressed RLE in 'segmentation', with
    MODEL.KEYPOINTS_ON its keypoints as COCO triplets in 'keypoints' and
    their score in 'kps_score'. With ``vis_dir`` each image is rendered
    there with its boxes, masks and keypoints. Fast R-CNN serves the
    'proposal_boxes' attached to the roidb's entries (the first
    TEST.PROPOSAL_LIMIT of each); TEST.BBOX_AUG / MASK_AUG / KPS_AUG run
    their test-time augmentation (module docstring).
    ``timing``, when given, receives the loop's wall seconds, its batches
    and images, and the seconds of each stage of SPLIT_KEYS."""
    infer = _make_infer_fn(cfg, model)
    rcnn = cfg.MODEL.TYPE in RCNN_SERVED
    # Fast R-CNN: precomputed proposals attached to the roidb (test.py
    # im_detect_all passes entry['boxes'] when not FASTER_RCNN)
    precomputed = cfg.MODEL.TYPE == "generalized_rcnn" and not cfg.MODEL.FASTER_RCNN and any(
        "proposal_boxes" in e for e in roidb)
    t = cfg.TEST
    bbox_aug = rcnn and t.BBOX_AUG.ENABLED
    mask_aug = rcnn and cfg.MODEL.MASK_ON and t.MASK_AUG.ENABLED
    kps_aug = rcnn and cfg.MODEL.KEYPOINTS_ON and t.KPS_AUG.ENABLED
    aux = None
    if (bbox_aug or mask_aug or kps_aug) and (cfg.MODEL.MASK_ON or cfg.MODEL.KEYPOINTS_ON):
        aux = make_aux_on_boxes_fn(cfg, model)
    dev = next(model.parameters()).device
    land, port = _test_canvas_shapes(cfg)
    groups = {"l": [], "p": []}
    for e in roidb:
        groups["l" if e["width"] >= e["height"] else "p"].append(e)

    detections: List[Dict] = []
    clock = time.perf_counter
    split = dict.fromkeys(SPLIT_KEYS, 0.0)
    batches, t_start = 0, clock()
    for key, canvas in (("l", land), ("p", port)):
        entries = groups[key]
        for i in range(0, len(entries), batch_size):
            chunk = entries[i:i + batch_size]
            # pad the final chunk to the static batch size; only chunk's
            # entries produce detections
            batch = _Batch(cfg, infer, aux, chunk + [chunk[-1]] * (batch_size - len(chunk)),
                           canvas, dev, precomputed, split, clock)
            host, tens = batch.tensors()
            batch.lap("load_resize")
            out = batch.boxes(tens)
            boxes, scores, classes, valid = (
                out[k].cpu().numpy() for k in ("boxes", "scores", "classes", "valid"))
            batch.lap("device")
            masks = heatmaps = None
            if bbox_aug:
                boxes, scores, classes, valid = _merge_box_passes(
                    cfg, batch, chunk, {"boxes": boxes, "scores": scores, "classes": classes,
                                        "valid": valid})
                if aux is not None:
                    # the masks and keypoints follow the MERGED boxes
                    out = batch.aux_on(host, tens, boxes, valid)
                    out["classes"] = torch.from_numpy(classes).to(dev)
                    batch.lap("aug_aux_passes")
            if "mask_prob" in out:
                masks = gather_class_masks(out["mask_prob"], out["classes"]).cpu().numpy()
            batch.lap("mask_gather")
            if "kps_heatmaps" in out:
                heatmaps = out["kps_heatmaps"].cpu().numpy()
            batch.lap("kps_copy")
            if mask_aug and masks is not None:
                masks = _aux_aug(cfg, batch, t.MASK_AUG, masks, boxes, valid, classes, "mask")
            if kps_aug and heatmaps is not None:
                heatmaps = _aux_aug(cfg, batch, t.KPS_AUG, heatmaps, boxes, valid, classes,
                                    "kps")
            t4 = clock()
            paste_s = rle_s = vis_s = decode_s = 0.0
            for j, e in enumerate(chunk):
                vis_segms = [None] * len(boxes[j])
                vis_kps = [None] * len(boxes[j])
                kp_xy, kp_keep = {}, None
                vidx = [k for k, v in enumerate(valid[j]) if v]
                if heatmaps is not None and vidx:
                    # decode every kept roi at once; optionally OKS-NMS over
                    # them (test.py keypoint_results + KRCNN.NMS_OKS)
                    td = clock()
                    xy_all = heatmaps_to_keypoints(heatmaps[j][vidx], boxes[j][vidx],
                                                   min_size=cfg.KRCNN.INFERENCE_MIN_SIZE)
                    kp_xy = dict(zip(vidx, xy_all))
                    if cfg.KRCNN.NMS_OKS:
                        kp_keep = {vidx[q] for q in nms_oks(xy_all, boxes[j][vidx], 0.3)}
                    decode_s += clock() - td
                for k, (b, s, c, v) in enumerate(zip(boxes[j], scores[j], classes[j], valid[j])):
                    if not v or (kp_keep is not None and k not in kp_keep):
                        continue
                    x1, y1, x2, y2 = (float(x) for x in b)
                    det = {
                        "image_id": e["id"],
                        "category_id": contiguous_to_json[int(c)],
                        # xyxy (legacy +1 extents) -> COCO xywh
                        "bbox": [x1, y1, x2 - x1 + 1.0, y2 - y1 + 1.0],
                        "score": float(s),
                    }
                    if heatmaps is not None:
                        # COCO keypoint triplets, and the keypoint task's score kept
                        # apart from the box score (json_dataset_evaluator
                        # _coco_kp_results_one_category:376-409)
                        xy = kp_xy[k]
                        det["keypoints"] = [v_ for ki in range(xy.shape[1])
                                            for v_ in (float(xy[0, ki]), float(xy[1, ki]), 1)]
                        conf = cfg.KRCNN.KEYPOINT_CONFIDENCE
                        det["kps_score"] = (float(xy[2].mean()) if conf == "logit" else
                                            float(xy[3].mean()) if conf == "prob" else float(s))
                        vis_kps[k] = xy  # the (4, K) rows: vis thresholds the logit row
                    if masks is not None:
                        # the roi-frame mask pasted into the image frame, as
                        # RLE (segm_results, test.py + segms utils)
                        ta = clock()
                        full = paste_mask_into_image(
                            masks[j, k], b, int(e["height"]), int(e["width"]),
                            cfg.MRCNN.THRESH_BINARIZE)
                        tb = clock()
                        det["segmentation"] = mask_to_rle(full)
                        paste_s += tb - ta
                        rle_s += clock() - tb
                        vis_segms[k] = full
                    detections.append(det)
                if vis_dir is not None:
                    tv = clock()
                    _vis_image(cfg, e, vis_dir, boxes[j], scores[j], classes[j], valid[j],
                               vis_segms if masks is not None else None,
                               vis_kps if heatmaps is not None else None)
                    vis_s += clock() - tv
            t5 = clock()
            batches += 1
            for name, sec in (("kps_decode", decode_s), ("paste", paste_s), ("rle", rle_s),
                              ("dicts", t5 - t4 - decode_s - paste_s - rle_s - vis_s),
                              ("vis", vis_s)):
                split[name] += sec
            if (i // batch_size) % 10 == 0:
                logger.info("inference %s: %d/%d (avg %.3fs/batch)", key, i + len(chunk),
                            len(entries), split["device"] / batches)
    wall = clock() - t_start
    logger.info("inference: %d images, %d batches in %.3f s; ms a batch: %s", len(roidb),
                batches, wall, ", ".join(f"{k} {1e3 * v / max(batches, 1):.1f}"
                                         for k, v in split.items()))
    if timing is not None:
        timing.update(split, wall=wall, batches=batches, images=len(roidb))
    return detections


def _served_order(roidb: List[dict]) -> List[dict]:
    """The order run_inference_on_roidb serves images in: the landscape
    ones (the _test_canvas_shapes grouping), then the portrait ones, each
    in roidb order."""
    return ([e for e in roidb if e["width"] >= e["height"]]
            + [e for e in roidb if e["width"] < e["height"]])


def run_inference_sharded(cfg, model, roidb: List[dict], contiguous_to_json: Dict[int, int],
                          batch_size: int = 8, vis_dir: Optional[str] = None,
                          timing: Optional[Dict[str, float]] = None) -> Optional[List[Dict]]:
    """run_inference_on_roidb over the ranks: rank r serves the r-th of W
    contiguous shards of roidb (ceil(N / W) images each, the last fewer),
    and rank 0 gets every detection in the order one process gives them;
    the other ranks get None. ``timing`` on rank 0 holds its own split, the
    slowest rank's wall seconds and every rank's wall seconds and images."""
    info = current()
    if info.world == 1:
        return run_inference_on_roidb(cfg, model, roidb, contiguous_to_json, batch_size,
                                      vis_dir=vis_dir, timing=timing)
    if len({e["id"] for e in roidb}) != len(roidb):
        raise ValueError("a sharded roidb needs unique image ids: the merge keys on them")
    per = -(-len(roidb) // info.world)
    mine: Dict[str, float] = {}
    dets = run_inference_on_roidb(cfg, model, roidb[info.rank * per:(info.rank + 1) * per],
                                  contiguous_to_json, batch_size, vis_dir=vis_dir, timing=mine)
    parts = gather_objects((dets, mine))
    if parts is None:
        return None
    by_image: Dict[int, List[Dict]] = {}
    for part, _ in parts:
        for d in part:
            by_image.setdefault(d["image_id"], []).append(d)
    if timing is not None:
        timing.update(parts[0][1], wall=max(t["wall"] for _, t in parts),
                      images=len(roidb), ranks=info.world,
                      rank_wall=[t["wall"] for _, t in parts],
                      rank_images=[t["images"] for _, t in parts])
    return [d for e in _served_order(roidb) for d in by_image.get(e["id"], [])]


def _vis_image(cfg, entry, vis_dir, boxes, scores, classes, valid, segms,
               keypoints=None) -> None:
    """One image's detection render, with mask overlays and keypoint skeletons (ref:
    test_engine.py:231-244 cfg.VIS dumps -> vis.py vis_one_image; threshold
    cfg.VIS_TH)."""
    from ..utils.vis import vis_one_image

    im_bgr = load_image_bgr(entry["image"], False)
    base = os.path.splitext(os.path.basename(entry["image"]))[0]
    os.makedirs(vis_dir, exist_ok=True)
    vis_one_image(im_bgr[:, :, ::-1], boxes, scores, classes, valid, thresh=cfg.VIS_TH,
                  out_path=os.path.join(vis_dir, base + ".png"), segms=segms, keypoints=keypoints)


def _dump_results_json(output_dir, results):
    """Persist the metrics dict next to bbox_results.json so CLI drivers and
    the dress rehearsal can consume APs without parsing logs."""
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "results.json"), "w") as f:
            json.dump({k: float(v) for k, v in results.items()}, f, indent=1)


def _refuse_unported_evaluator(cfg, name: str) -> None:
    """The evaluator dispatch by dataset name (ref: task_evaluation.py:256-266
    _use_cityscapes/_use_voc/_use_vid_evaluator; sad_tpu/eval/test_engine.py:
    578-607): the COCO evaluator is ported, the others raise."""
    if "cityscapes_" in name and cfg.MODEL.MASK_ON:
        evaluator = "the Cityscapes mask evaluator (eval/cityscapes_eval.py)"
    elif name.startswith("vid"):
        evaluator = "the VID evaluator (eval/vid_eval.py)"
    elif name.startswith("voc_") and not cfg.TEST.FORCE_JSON_DATASET_EVAL:
        evaluator = "the VOC evaluator (eval/voc_eval.py; TEST.FORCE_JSON_DATASET_EVAL " \
                    "takes the COCO one)"
    else:
        return
    raise NotImplementedError(f"dataset {name!r}: {evaluator} is not ported to sad_tpu_torch "
                              "yet (ROADMAP.md Queue 1 item 9)")


def attach_test_proposals(cfg, roidb: List[dict], name: str) -> None:
    """Fast R-CNN: the TEST.PROPOSAL_FILES entry of dataset ``name``
    attached to ``roidb``, the first TEST.PROPOSAL_LIMIT of each image
    (sad_tpu/eval/test_engine.py:543-565). The files pair positionally with
    TEST.DATASETS, and a wrong file would silently give every image zero
    proposals (an image-id mismatch), so an unpaired dataset raises."""
    from .rpn_generator import add_proposals_to_roidb

    if name not in cfg.TEST.DATASETS:
        raise ValueError(f"TEST.PROPOSAL_FILES is set but dataset {name!r} is not in "
                         f"TEST.DATASETS {cfg.TEST.DATASETS}: cannot pick its proposal file")
    idx = list(cfg.TEST.DATASETS).index(name)
    if idx >= len(cfg.TEST.PROPOSAL_FILES):
        raise ValueError("TEST.PROPOSAL_FILES must pair 1:1 with TEST.DATASETS (got "
                         f"{len(cfg.TEST.PROPOSAL_FILES)} files, dataset {name!r} is index "
                         f"{idx})")
    add_proposals_to_roidb(roidb, cfg.TEST.PROPOSAL_FILES[idx], top_k=cfg.TEST.PROPOSAL_LIMIT)


def test_net_on_dataset(cfg, model, dataset_name: Optional[str] = None, batch_size: int = 8,
                        output_dir: Optional[str] = None,
                        im_range: Optional[Tuple[int, int]] = None,
                        multi_gpu: bool = False) -> Dict[str, float]:
    """Run inference + COCO evaluation on cfg.TEST.DATASETS[0] (or
    ``dataset_name``): the 12 bbox metrics, under MODEL.MASK_ON the 12 segm
    ones with the ``segm_`` prefix and under MODEL.KEYPOINTS_ON the 10
    keypoint ones with the ``keypoints_`` prefix (ranked by 'kps_score').
    Writes bbox_results.json, results.json and timing.json
    (run_inference_on_roidb's split and the seconds of each evaluation,
    'eval_bbox', 'eval_segm', 'eval_keypoints') into ``output_dir`` when one
    is given.

    im_range=(start, end) evaluates only that slice of the dataset's images
    (ref test_net.py --range, the reference's subprocess-sharding unit).
    ``multi_gpu`` under torchrun: the slice is served sharded over the
    ranks (run_inference_sharded); rank 0 evaluates and writes, and every
    rank returns its results."""
    name = dataset_name or cfg.TEST.DATASETS[0]
    _refuse_unported_inference(cfg)
    _refuse_unported_evaluator(cfg, name)
    ds = CocoDataset(name)
    roidb = ds.get_roidb(include_gt=False)
    if im_range is not None:
        roidb = roidb[im_range[0]:im_range[1]]
    if cfg.TEST.PROPOSAL_FILES:
        # before the roidb is sharded: each rank serves its own images' proposals
        attach_test_proposals(cfg, roidb, name)
    vis_dir = (os.path.join(output_dir or get_output_dir(cfg, training=False), "vis")
               if cfg.VIS else None)
    timing: Dict[str, float] = {}
    sharded = multi_gpu and world_size() > 1
    if sharded:
        dets = run_inference_sharded(cfg, model, roidb, ds.contiguous_to_json, batch_size,
                                     vis_dir=vis_dir, timing=timing)
        if dets is None:
            return broadcast_object(None)
    else:
        dets = run_inference_on_roidb(cfg, model, roidb, ds.contiguous_to_json, batch_size,
                                      vis_dir=vis_dir, timing=timing)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "bbox_results.json"), "w") as f:
            json.dump(dets, f)
    t0 = time.perf_counter()
    results = COCOEvaluator(ds.dataset).evaluate(dets, verbose=True)
    timing["eval_bbox"] = time.perf_counter() - t0
    if cfg.MODEL.MASK_ON and dets and "segmentation" in dets[0]:
        t0 = time.perf_counter()
        segm = COCOEvaluator(ds.dataset, iou_type="segm").evaluate(dets, verbose=True)
        timing["eval_segm"] = time.perf_counter() - t0
        results.update({f"segm_{k}": v for k, v in segm.items()})
    if cfg.MODEL.KEYPOINTS_ON and any("keypoints" in d for d in dets):
        # the keypoint task ranked by the keypoint score (json_dataset_evaluator
        # _do_keypoint_eval and the per-result score of :376-409)
        t0 = time.perf_counter()
        kp_dets = [dict(d, score=d.get("kps_score", d["score"])) for d in dets
                   if "keypoints" in d]
        kps = COCOEvaluator(ds.dataset, iou_type="keypoints").evaluate(kp_dets, verbose=True)
        timing["eval_keypoints"] = time.perf_counter() - t0
        results.update({f"keypoints_{k}": v for k, v in kps.items()})
    _dump_results_json(output_dir, results)
    if output_dir:
        with open(os.path.join(output_dir, "timing.json"), "w") as f:
            json.dump(timing, f, indent=1)
    return broadcast_object(results) if sharded else results


def generate_pseudo_labels(cfg, model, dataset_name: str, out_json: str,
                           score_thresh: float = 0.5, batch_size: int = 8,
                           multi_gpu: bool = False) -> str:
    """The teacher's pseudo-label writer: a COCO-format annotation json over
    an unlabeled dataset (the reference's semi-supervised flow, SURVEY.md
    §3.4), usable as a catalog entry for DISTILLATION.UNLABEL_DATASETS.
    ``multi_gpu`` under torchrun: served sharded over the ranks; rank 0
    writes the merged set (annotation ids follow the one-process order) and
    every rank returns once it is written."""
    ds = CocoDataset(dataset_name)
    roidb = ds.get_roidb(include_gt=False)
    if multi_gpu and world_size() > 1:
        dets = run_inference_sharded(cfg, model, roidb, ds.contiguous_to_json, batch_size)
        if dets is not None:
            _write_pseudo_labels(ds, dets, out_json, score_thresh)
        barrier()
        return out_json
    dets = run_inference_on_roidb(cfg, model, roidb, ds.contiguous_to_json, batch_size)
    _write_pseudo_labels(ds, dets, out_json, score_thresh)
    return out_json


def _write_pseudo_labels(ds, dets: List[Dict], out_json: str, score_thresh: float) -> None:
    anns = []
    for i, d in enumerate(dets):
        if d["score"] < score_thresh:
            continue
        x, y, w, h = d["bbox"]
        anns.append({
            "id": i + 1,
            "image_id": d["image_id"],
            "category_id": d["category_id"],
            "bbox": d["bbox"],
            "area": float(w * h),
            "iscrowd": 0,
            "score": d["score"],  # kept for filtering and inspection
        })
    out = {
        "images": ds.dataset["images"],
        "categories": ds.dataset["categories"],
        "annotations": anns,
    }
    os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(out, f)
    logger.info("Wrote %d pseudo annotations for %d images -> %s",
                len(anns), len(ds.dataset["images"]), out_json)
