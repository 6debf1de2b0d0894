"""Exact-mode prediction: the winner mask of Algorithm 2 folded into one
label and confidence per query.

Port of ``repro.predict.vote``.  The reference's psum over the mesh axis
is a sum over the shard dimension (``parallel.collectives.psum``): only
the ``(B, C)`` histogram or the ``(B,)`` value sum and count cross the
shards, never the points or their labels.  Classification ties go to the
lowest class (``argmax`` takes the first maximum), on every device and
every shard count.
"""

from __future__ import annotations

import torch

from repro_torch.core import knn
from repro_torch.parallel.collectives import psum


def exact_predict(res: knn.KnnResult, l_run, *, predict: str,
                  num_classes: int):
    """``(label (B,) f32, confidence (B,) f32, detail)`` from ``res``
    (carrying ``local_labels``) at the batch's ranks ``l_run``.

    ``predict="vote"``: the majority class over the l winners as f32,
    its vote share, and the ``(B, C)`` int32 histogram.
    ``predict="regress"``: the mean label over the winners, the share of
    the requested l actually found, and the ``(B, 2)`` [sum, count].
    Rows with ``l_run == 0`` (bucket padding) have an empty mask: label
    -1 and confidence 0 (vote), or 0 and 0 (regress).
    """
    labels = res.local_labels
    l_f = torch.clamp(torch.as_tensor(l_run, dtype=torch.float32,
                                      device=labels.device), min=1.0)
    if predict == "vote":
        cls, hist = knn.knn_classify(res.mask, labels.to(torch.int32),
                                     num_classes)
        total = hist.sum(-1, dtype=torch.int32)
        top = hist.max(-1).values
        conf = top.to(torch.float32) / torch.clamp(
            total.to(torch.float32), min=1.0)
        label = torch.where(total > 0, cls, -1).to(torch.float32)
        return label, conf, hist
    num = psum(torch.where(res.mask, labels, 0.0).sum(-1))
    den = psum(res.mask.sum(-1).to(torch.float32))
    label = num / torch.clamp(den, min=1.0)
    return label, den / l_f, torch.stack([num, den], dim=-1)
