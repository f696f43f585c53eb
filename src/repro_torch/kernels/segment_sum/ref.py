"""Loop oracle for the segment sum: numpy, one term at a time.

``segment_sum_ref`` adds ``data[e]`` into row ``segment_ids[e]`` for e =
0, 1, ... in float32, starting from zeros, skipping ids outside
``[0, num_segments)``: the order and the rounding that the plain version
(``index_add_`` on the CPU) and the kernel (a stable sort, then each
row's terms in order) both keep, so all three agree bit for bit.
"""

from __future__ import annotations

import numpy as np


def segment_sum_ref(data, segment_ids, num_segments: int) -> np.ndarray:
    data = np.asarray(data, np.float32)
    ids = np.asarray(segment_ids)
    out = np.zeros((num_segments,) + data.shape[1:], np.float32)
    for e, r in enumerate(ids.tolist()):
        if 0 <= r < num_segments:
            out[r] = out[r] + data[e]
    return out
