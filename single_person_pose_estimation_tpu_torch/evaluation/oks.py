"""Native COCO keypoint evaluation (OKS mAP) — no pycocotools.

Reimplements the COCOeval "keypoints" protocol the reference runs through
pycocotools' C extension (eval.py:39-49): OKS similarity, greedy
score-ordered matching per OKS threshold, precision/recall accumulation
over 101 recall points, and the 10-element stats vector printed by
`summarize` — so `eval_oks(predictions, gt_path)` is a drop-in for the
reference's `eval_OKS` in an environment without pycocotools.

Protocol constants (matching pycocotools cocoeval.py Params for keypoints):
  * OKS thresholds 0.50:0.05:0.95; recall thresholds 0:0.01:1 (101 pts)
  * maxDets = 20; area ranges all / medium [32^2, 96^2] / large [96^2, 1e10]
  * per-keypoint sigmas (kpt_oks_sigmas)
  * GT with num_keypoints == 0 is ignored; crowd GTs match repeatedly

OKS(dt, gt) = mean over labeled gt keypoints of exp(-d_i^2 / (2 s^2 k_i^2))
with s^2 = gt area and k_i = 2 sigma_i; for GTs with no labeled keypoints
the distance is measured to the bbox expanded by 2s (as in computeOks).

The OKS matrices are numpy-vectorized over (detections x GTs x keypoints);
matching/accumulation is exact scalar logic (tiny: ~5.6k val images).

The port's copy of the JAX package's `evaluation/oks.py` (numpy only,
unchanged); `tests/test_torch_eval_metrics.py` holds the two equal.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

KPT_OKS_SIGMAS = np.array([
    .026, .025, .025, .035, .035, .079, .079, .072, .072,
    .062, .062, .107, .107, .087, .087, .089, .089])

OKS_THRESHOLDS = np.linspace(0.5, 0.95, 10)
RECALL_THRESHOLDS = np.linspace(0.0, 1.0, 101)
MAX_DETS = 20
AREA_RANGES = {
    "all": (0.0, 1e10),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def compute_oks_matrix(dts: List[dict], gts: List[dict],
                       sigmas: np.ndarray = KPT_OKS_SIGMAS) -> np.ndarray:
    """OKS between every (detection, gt) pair in one image.

    dts: [{"keypoints": [x,y,v]*17, "score": float}], score-sorted outside.
    gts: [{"keypoints": [...], "area": float, "bbox": [x,y,w,h]}].
    Returns (len(dts), len(gts)).
    """
    if not dts or not gts:
        return np.zeros((len(dts), len(gts)))
    k = len(sigmas)
    vars_ = (sigmas * 2) ** 2

    d = np.asarray([dt["keypoints"] for dt in dts], dtype=np.float64)
    dx = d[:, 0::3]
    dy = d[:, 1::3]

    ious = np.zeros((len(dts), len(gts)))
    for j, gt in enumerate(gts):
        g = np.asarray(gt["keypoints"], dtype=np.float64)
        xg, yg, vg = g[0::3], g[1::3], g[2::3]
        k1 = int((vg > 0).sum())
        area = max(float(gt.get("area", 0.0)), 0.0)
        bb = gt.get("bbox", [0, 0, 0, 0])
        if k1 > 0:
            d2 = (dx - xg[None, :]) ** 2 + (dy - yg[None, :]) ** 2
        else:
            # No labeled keypoints: distance to the 2s-expanded bbox.
            z = np.sqrt(area) * 2
            x0, x1 = bb[0] - z, bb[0] + bb[2] + z
            y0, y1 = bb[1] - z, bb[1] + bb[3] + z
            ddx = np.maximum(0, np.maximum(x0 - dx, dx - x1))
            ddy = np.maximum(0, np.maximum(y0 - dy, dy - y1))
            d2 = ddx ** 2 + ddy ** 2
        e = d2 / vars_[None, :] / (area + np.spacing(1)) / 2.0
        if k1 > 0:
            e = e[:, vg > 0]
        ious[:, j] = np.exp(-e).sum(axis=1) / e.shape[1]
    return ious


def _evaluate_image(dts: List[dict], gts: List[dict], area_rng, ious_full):
    """Match detections to GTs for one (image, area-range): pycocotools
    evaluateImg. Returns dict of match/ignore arrays, or None if empty."""
    T = len(OKS_THRESHOLDS)
    for g in gts:
        g["_ignore"] = 1 if (g.get("ignore", 0) or g["area"] < area_rng[0]
                             or g["area"] > area_rng[1]) else 0
    gtind = np.argsort([g["_ignore"] for g in gts], kind="mergesort")
    gts = [gts[i] for i in gtind]
    dtind = np.argsort([-d["score"] for d in dts], kind="mergesort")
    dts = [dts[i] for i in dtind][:MAX_DETS]
    iscrowd = [int(g.get("iscrowd", 0)) for g in gts]
    ious = ious_full[dtind[:len(dts)], :][:, gtind] if len(gts) and len(dts) \
        else np.zeros((len(dts), len(gts)))

    G, D = len(gts), len(dts)
    gtm = np.zeros((T, G))
    dtm = np.zeros((T, D))
    gt_ig = np.array([g["_ignore"] for g in gts])
    dt_ig = np.zeros((T, D))
    if len(ious):
        for tind, t in enumerate(OKS_THRESHOLDS):
            for dind in range(D):
                iou = min(t, 1 - 1e-10)
                m = -1
                for gind in range(G):
                    if gtm[tind, gind] > 0 and not iscrowd[gind]:
                        continue
                    if m > -1 and gt_ig[m] == 0 and gt_ig[gind] == 1:
                        break
                    if ious[dind, gind] < iou:
                        continue
                    iou = ious[dind, gind]
                    m = gind
                if m == -1:
                    continue
                dt_ig[tind, dind] = gt_ig[m]
                dtm[tind, dind] = m + 1
                gtm[tind, m] = dind + 1
    # Detections unmatched and outside the area range are ignored.
    a = np.array([d["area"] < area_rng[0] or d["area"] > area_rng[1]
                  for d in dts]).reshape((1, D)) if D else np.zeros((1, 0))
    dt_ig = np.logical_or(dt_ig, np.logical_and(dtm == 0,
                                                np.repeat(a, T, axis=0)))
    return {
        "dtm": dtm,
        "dt_ig": dt_ig,
        "gt_ig": gt_ig,
        "scores": np.array([d["score"] for d in dts]),
    }


def _accumulate(per_image: List[Optional[dict]]):
    """pycocotools accumulate over one (category, areaRng): returns
    (precision[T, R], recall[T])."""
    T = len(OKS_THRESHOLDS)
    R = len(RECALL_THRESHOLDS)
    precision = -np.ones((T, R))
    recall = -np.ones(T)
    per_image = [e for e in per_image if e is not None]
    if not per_image:
        return precision, recall
    scores = np.concatenate([e["scores"] for e in per_image])
    inds = np.argsort(-scores, kind="mergesort")
    dtm = np.concatenate([e["dtm"] for e in per_image], axis=1)[:, inds]
    dt_ig = np.concatenate([e["dt_ig"] for e in per_image], axis=1)[:, inds]
    gt_ig = np.concatenate([e["gt_ig"] for e in per_image])
    npig = int((gt_ig == 0).sum())
    if npig == 0:
        return precision, recall

    tps = np.logical_and(dtm, np.logical_not(dt_ig))
    fps = np.logical_and(np.logical_not(dtm), np.logical_not(dt_ig))
    tp_sum = np.cumsum(tps, axis=1).astype(dtype=np.float64)
    fp_sum = np.cumsum(fps, axis=1).astype(dtype=np.float64)
    for t in range(T):
        tp = tp_sum[t]
        fp = fp_sum[t]
        nd = len(tp)
        rc = tp / npig
        pr = tp / (fp + tp + np.spacing(1))
        recall[t] = rc[-1] if nd else 0
        q = np.zeros(R)
        pr = pr.tolist()
        for i in range(nd - 1, 0, -1):      # interpolated precision
            if pr[i] > pr[i - 1]:
                pr[i - 1] = pr[i]
        inds_r = np.searchsorted(rc, RECALL_THRESHOLDS, side="left")
        for ri, pi in enumerate(inds_r):
            if pi < nd:
                q[ri] = pr[pi]
        precision[t] = q
    return precision, recall


class KeypointEval:
    """COCOeval(keypoints)-equivalent evaluator."""

    def __init__(self, gt_annotations, predictions: Sequence[dict],
                 image_ids: Optional[Sequence[int]] = None):
        """gt_annotations: path to person_keypoints_*.json or parsed dict.
        predictions: [{"image_id", "keypoints" ([x,y,v]*17), "score"}].
        image_ids: restrict evaluation to these images (the reference sets
        imgIds to the predicted images, eval.py:44)."""
        if isinstance(gt_annotations, str):
            with open(gt_annotations) as f:
                gt_annotations = json.load(f)
        self.img_ids = sorted(set(int(i) for i in image_ids)) \
            if image_ids is not None else None

        self.gts: Dict[int, List[dict]] = {}
        for ann in gt_annotations["annotations"]:
            if ann.get("category_id", 1) != 1:
                continue
            img = int(ann["image_id"])
            if self.img_ids is not None and img not in set(self.img_ids):
                continue
            g = dict(ann)
            # keypoints task: GTs without labeled keypoints are ignored.
            g["ignore"] = int(ann.get("iscrowd", 0) == 1
                              or ann.get("num_keypoints", 0) == 0)
            if "area" not in g:
                # COCO GT files carry segmentation area; fall back to the
                # bbox area when absent (synthetic/minimal annotations).
                bb = g.get("bbox", [0, 0, 0, 0])
                g["area"] = float(bb[2]) * float(bb[3])
            self.gts.setdefault(img, []).append(g)

        self.dts: Dict[int, List[dict]] = {}
        for p in predictions:
            img = int(p["image_id"])
            d = dict(p)
            kp = np.asarray(p["keypoints"], dtype=np.float64)
            xs, ys = kp[0::3], kp[1::3]
            # pycocotools loadRes computes detection area from the keypoint
            # extent bbox.
            d["area"] = float((xs.max() - xs.min()) * (ys.max() - ys.min()))
            self.dts.setdefault(img, []).append(d)

        if self.img_ids is None:
            self.img_ids = sorted(set(self.gts) | set(self.dts))

    def evaluate(self) -> np.ndarray:
        """Run the protocol; returns the 10-element stats vector
        [AP, AP50, AP75, APm, APl, AR, AR50, AR75, ARm, ARl]."""
        # OKS matrices once per image (score-sorted detections).
        sorted_dts = {img: sorted(self.dts.get(img, []),
                                  key=lambda d: -d["score"])
                      for img in self.img_ids}
        ious = {img: compute_oks_matrix(sorted_dts[img],
                                        self.gts.get(img, []))
                for img in self.img_ids}

        results = {}
        for name, rng in AREA_RANGES.items():
            per_image = []
            for img in self.img_ids:
                gts = [dict(g) for g in self.gts.get(img, [])]
                dts = sorted_dts[img]
                if not gts and not dts:
                    per_image.append(None)
                    continue
                per_image.append(_evaluate_image(dts, gts, rng, ious[img]))
            results[name] = _accumulate(per_image)

        def ap(name, thr=None):
            p, _ = results[name]
            if thr is not None:
                p = p[np.isclose(OKS_THRESHOLDS, thr)]
            valid = p[p > -1]
            return float(valid.mean()) if valid.size else -1.0

        def ar(name, thr=None):
            _, r = results[name]
            if thr is not None:
                r = r[np.isclose(OKS_THRESHOLDS, thr)]
            valid = r[r > -1]
            return float(valid.mean()) if valid.size else -1.0

        stats = np.array([
            ap("all"), ap("all", 0.5), ap("all", 0.75),
            ap("medium"), ap("large"),
            ar("all"), ar("all", 0.5), ar("all", 0.75),
            ar("medium"), ar("large"),
        ])
        return stats

    @staticmethod
    def summarize(stats: np.ndarray) -> str:
        names = [
            ("Average Precision  (AP)", "0.50:0.95", "   all"),
            ("Average Precision  (AP)", "0.50     ", "   all"),
            ("Average Precision  (AP)", "0.75     ", "   all"),
            ("Average Precision  (AP)", "0.50:0.95", "medium"),
            ("Average Precision  (AP)", "0.50:0.95", " large"),
            ("Average Recall     (AR)", "0.50:0.95", "   all"),
            ("Average Recall     (AR)", "0.50     ", "   all"),
            ("Average Recall     (AR)", "0.75     ", "   all"),
            ("Average Recall     (AR)", "0.50:0.95", "medium"),
            ("Average Recall     (AR)", "0.50:0.95", " large"),
        ]
        lines = []
        for (title, iou, area), s in zip(names, stats):
            lines.append(f" {title} @[ IoU={iou} | area={area} | "
                         f"maxDets= 20 ] = {s:0.3f}")
        return "\n".join(lines)


def eval_oks(predictions, gt_path: str, verbose: bool = True) -> np.ndarray:
    """Drop-in for the reference's eval_OKS (eval.py:9-51): takes the
    prediction list (or JSON path) produced by predict_ds, builds
    COCO-format detections, evaluates restricted to predicted image ids,
    prints the summary, returns the 10 stats."""
    if isinstance(predictions, str):
        with open(predictions) as f:
            predictions = json.load(f)

    dets = []
    image_ids = []
    for p in predictions:
        coco_kpts = []
        for x, y in zip(p["xs/pred"], p["ys/pred"]):
            # Reference casts predicted coords to int (eval.py:25-27).
            coco_kpts += [int(x), int(y), 1]
        dets.append({
            "image_id": int(p["image_id"]),
            "ann_id": p.get("ann_id"),
            "category_id": 1,
            "keypoints": coco_kpts,
            "score": float(np.mean(p["confs"])),
        })
        image_ids.append(int(p["image_id"]))

    ev = KeypointEval(gt_path, dets, image_ids=image_ids)
    stats = ev.evaluate()
    if verbose:
        print("\nSummary: ")
        print(KeypointEval.summarize(stats))
    return stats
