"""RoboWatch transfer-evaluation dataset (config 5; the port of
`nafae_tpu/data/robowatch.py`).

The same on-disk layout as YouCook2 (the extraction pipeline is shared),
eval only: the val split, with ground truth. To ingest the authors'
annotation release, run `python -m nafae_torch.extract --robowatch-json
<file> --video-dir <dir> --out <root>/val` (`data/annotations.py`:
`segments_from_robowatch` and `gt_from_robowatch` give the segment list
and merge the ground-truth boxes into the extracted features).
"""

from __future__ import annotations

from nafae_torch.data.youcook2 import SegmentDataset


class RoboWatchDataset(SegmentDataset):
    def __init__(self, root: str, max_frames: int, num_regions: int,
                 feat_dim: int, max_words: int):
        super().__init__(root, "val", max_frames, num_regions, feat_dim,
                         max_words, with_gt=True)
