"""DEFLATE decode constants (counterpart of the constant rows at
``libflate_tpu/ops/pallas_decode.py:40-56``).

The reference pads each row to the TPU's 128 lanes; here they are plain
arrays of their true length, and the kernels copy them to shared memory.
"""
from __future__ import annotations

import numpy as np

from ..spec import constants as C

ROOT_BITS = 12               # widest litlen root the shared tables allow
DIST_ROOT_BITS = 8           # distance root (30 symbols, codes <= 8 bits)

LEN_BASE = np.asarray(C.LENGTH_BASE, np.int32)      # (29,)
LEN_EXTRA = np.asarray(C.LENGTH_EXTRA, np.int32)    # (29,)
DIST_BASE = np.asarray(C.DIST_BASE, np.int32)       # (30,)
DIST_EXTRA = np.asarray(C.DIST_EXTRA, np.int32)     # (30,)
