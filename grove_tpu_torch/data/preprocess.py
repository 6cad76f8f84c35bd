"""Normalization constants of the two vision towers.

Copies of `grove_tpu/data/preprocess.py:21-24` (CLIP ViT-L/336's and SAM's
pixel statistics). Copied because `grove_tpu.data.preprocess` imports PIL;
a test holds them equal to the originals.
"""

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
SAM_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_STD = np.array([58.395, 57.12, 57.375], np.float32)
