"""Evaluation report artifacts: the OKS/PCK figures the reference publishes.

The port's copy of the JAX package's `utils/reporting.py` (framework-free:
numpy, and matplotlib imported lazily). The reference's README embeds its
evaluation results as images (README.md:38-43 -> figures/OKS.PNG,
figures/PCK.PNG, captured from evaluation.ipynb cells 8-9). This module
generates the equivalent artifacts programmatically from
`evaluation.oks.eval_oks` stats and `evaluation.pck.eval_pck` results: a
markdown report plus matplotlib figures, so `cli eval --report PREFIX`
leaves the evidence of a run instead of notebook screenshots.

The figure writers build Figure + FigureCanvasAgg objects directly (never
touching pyplot or the global backend), so reports work on headless hosts
without hijacking an interactive session's backend.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

_OKS_ROWS = (
    ("AP", "0.50:0.95", "all"),
    ("AP", "0.50", "all"),
    ("AP", "0.75", "all"),
    ("AP", "0.50:0.95", "medium"),
    ("AP", "0.50:0.95", "large"),
    ("AR", "0.50:0.95", "all"),
    ("AR", "0.50", "all"),
    ("AR", "0.75", "all"),
    ("AR", "0.50:0.95", "medium"),
    ("AR", "0.50:0.95", "large"),
)


def eval_report_markdown(oks_stats: Optional[Sequence[float]],
                         pck_stats: Sequence[float],
                         keypoint_labels: Sequence[str],
                         pck_threshold: float = 0.05) -> str:
    """Markdown with the 10-element OKS stats vector (COCOeval keypoints
    order, evaluation/oks.py) and per-keypoint PCK — the same numbers the
    reference publishes in its README figures."""
    lines = ["# Evaluation report", ""]
    if oks_stats is not None:
        lines += ["## COCO OKS (keypoints protocol)", "",
                  "| metric | IoU | area | value |", "|---|---|---|---|"]
        for (name, iou, area), v in zip(_OKS_ROWS, oks_stats):
            lines.append(f"| {name} | {iou} | {area} | {float(v):.3f} |")
        lines.append("")
    lines += [f"## PCK@{pck_threshold:g} (bbox-diagonal)", "",
              "| keypoint | PCK |", "|---|---|"]
    for label, v in zip(keypoint_labels, pck_stats):
        lines.append(f"| {label} | {float(v):.2f} |")
    lines.append("")
    return "\n".join(lines)


def _agg_figure(width: float, height: float):
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    fig = Figure(figsize=(width, height))
    FigureCanvasAgg(fig)  # attaches itself as fig.canvas (savefig target)
    return fig


def save_pck_figure(pck_stats: Sequence[float],
                    keypoint_labels: Sequence[str], path: str,
                    pck_threshold: float = 0.05) -> str:
    """Per-keypoint PCK bar chart (the reference's PCK.PNG equivalent)."""
    fig = _agg_figure(10, 4)
    ax = fig.add_subplot(111)
    xs = np.arange(len(keypoint_labels))
    ax.bar(xs, np.asarray(pck_stats, dtype=np.float64))
    ax.set_xticks(xs)
    ax.set_xticklabels(keypoint_labels, rotation=45, ha="right")
    ax.set_ylim(0.0, 1.0)
    ax.set_ylabel(f"PCK@{pck_threshold:g}")
    ax.set_title("Per-keypoint PCK (threshold = "
                 f"{pck_threshold:g} x bbox diagonal)")
    for x, v in zip(xs, pck_stats):
        ax.text(x, float(v) + 0.01, f"{float(v):.2f}",
                ha="center", va="bottom", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    return path


def save_oks_figure(oks_stats: Sequence[float], path: str) -> str:
    """OKS AP/AR bar chart (the reference's OKS.PNG equivalent)."""
    fig = _agg_figure(10, 4)
    ax = fig.add_subplot(111)
    labels = [f"{n} {iou}\n{area}" for n, iou, area in _OKS_ROWS]
    xs = np.arange(len(labels))
    ax.bar(xs, np.asarray(oks_stats, dtype=np.float64))
    ax.set_xticks(xs)
    ax.set_xticklabels(labels, fontsize=8)
    ax.set_ylim(0.0, 1.0)
    ax.set_title("COCO OKS keypoints evaluation")
    for x, v in zip(xs, oks_stats):
        ax.text(x, max(float(v), 0.0) + 0.01, f"{float(v):.3f}",
                ha="center", va="bottom", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    return path


def save_eval_report(prefix: str,
                     pck_stats: Sequence[float],
                     keypoint_labels: Sequence[str],
                     oks_stats: Optional[Sequence[float]] = None,
                     pck_threshold: float = 0.05) -> List[str]:
    """Write `<prefix>.md` (+ `<prefix>_pck.png`, `<prefix>_oks.png` when
    stats are given). Returns the written paths."""
    paths = [prefix + ".md"]
    with open(paths[0], "w") as f:
        f.write(eval_report_markdown(oks_stats, pck_stats, keypoint_labels,
                                     pck_threshold))
    paths.append(save_pck_figure(pck_stats, keypoint_labels,
                                 prefix + "_pck.png", pck_threshold))
    if oks_stats is not None:
        paths.append(save_oks_figure(oks_stats, prefix + "_oks.png"))
    return paths
